"""The mesh backends of the CUDA megakernel, compiled for the host and held
to their plain PyTorch versions.

`csrc/mesh.cuh` (K7) and `csrc/bigmesh.cuh` (K8) are plain C++ behind the
shim of tests/test_torch_kernel_host.py, so g++ builds them with
-ffp-contract=off and a host loop runs `trace_sample` with each backend for
every pixel as K1's threads do, on the packed vector, the topology and the
tables that ops/megakernel hands the kernel. Each frame is held per pixel
to the plain version (the eager integrator on models/mesh, models/bigmesh)
within chip_smoke.py's image gate. The card run checks what nvcc makes of
it.
"""

import ctypes

import numpy as np
import pytest
import torch

from pathtracer_tpu_torch.integrator.tracer import FIXED, VERBATIM
from pathtracer_tpu_torch.models import bigmesh, mesh
from pathtracer_tpu_torch.models import light as L
from pathtracer_tpu_torch.ops import megakernel as MK
from pathtracer_tpu_torch.ops import rng
from pathtracer_tpu_torch.ops.vecmath import V3
from test_torch_kernel_host import PRELUDE, build_shim, launch_keys, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SHIM = PRELUDE + r"""
#include "bigmesh.cuh"
#include "mesh.cuh"
#include "tracer.cuh"

template <class B>
static void frame(const pt::SceneView& s, const uint32_t* keys, float* out, int width, int height, int spp,
                  int depth, int flags) {
  const int n = width * height;
  for (int p = 0; p < n; ++p) {
    pt::V3 sum = pt::splat3(0.0f);
    for (int k = 0; k < spp; ++k) {
      const uint32_t* kk = keys + 4 * k;
      pt::V3 r = pt::trace_sample<B>(s, p, n, width, height, depth, flags, kk[0], kk[1], kk[2], kk[3]);
      sum = k == 0 ? r : sum + r;
    }
    if (spp > 1) sum = sum / (float)spp;
    out[4 * p + 0] = sum.x;
    out[4 * p + 1] = sum.y;
    out[4 * p + 2] = sum.z;
    out[4 * p + 3] = 1.0f;
  }
}

extern "C" void host_render_mesh(const float* sv, const uint32_t* keys, float* out, int width, int height, int spp,
                                 int depth, int n_lights, int n_materials, int flags, const int* topo, int n_tris,
                                 int n_verts) {
  frame<pt::Mesh>(pt::mesh_view(sv, n_lights, n_materials, topo, n_tris, n_verts), keys, out, width, height, spp,
                  depth, flags);
}

extern "C" void host_render_bigmesh(const float* sv, const uint32_t* keys, float* out, int width, int height,
                                    int spp, int depth, int n_lights, int n_materials, int flags, const float* coef,
                                    const float* attr, const float* aabb, int n_chunks) {
  frame<pt::BigMesh>(pt::bigmesh_view(sv, n_lights, n_materials, coef, attr, aabb, n_chunks), keys, out, width,
                     height, spp, depth, flags);
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    lib = build_shim(tmp_path_factory.mktemp("mesh_kernel_host"), SHIM)
    p, i = ctypes.c_void_p, ctypes.c_int
    head = [p, p, p, i, i, i, i, i, i, i]
    lib.host_render_mesh.argtypes = head + [p, i, i]
    lib.host_render_bigmesh.argtypes = head + [p, p, p, i]
    return lib


def host_render(lib, scene, key, w, h, spp, quirks):
    """What render_frame_megakernel hands K1, run on the host."""
    family = "mesh" if scene.closest_hit_fn is mesh.closest_hit else "bigmesh"
    b = MK.BACKENDS[family]
    # held: the library reads their memory
    sv, keys, extras = b.pack(scene, w, h).contiguous(), launch_keys(key, spp), b.extras(scene)
    out = torch.empty((h, w, 4), dtype=torch.float32)
    entry = lib.host_render_mesh if family == "mesh" else lib.host_render_bigmesh
    entry(sv.data_ptr(), keys.data_ptr(), out.data_ptr(), w, h, spp, scene.recursion_depth, scene.num_lights,
          int(scene.params.materials.roughness.shape[0]), MK.kernel_flags(scene, quirks),
          *(t.data_ptr() for t in extras), *b.counts(scene))
    return out


def _moved_vertex_mesh():
    """The mesh demo with the pyramid's apex moved and a rectangular light
    beside the spherical one."""
    p = mesh.default_params()
    v = p.vertices
    x, y = v.x.clone(), v.y.clone()
    x[16], y[16] = 1.1, 1.2
    lights = L.concat_lights(
        L.spherical_light((3.0, 2.0, 2.0), 1.0, (3.0, 3.0, 3.0)),
        L.rect_light((-2.0, 3.0, -1.0), (1.0, 0.0, 0.0), (0.0, 0.0, 1.0), (2.0, 2.0, 2.0)),
    )
    return mesh.make_scene(params=p._replace(vertices=V3(x, y, v.z)), lights=lights)


CASES = {
    "mesh_verbatim": (lambda: mesh.make_scene(), 1, VERBATIM),
    "mesh_spp2": (lambda: mesh.make_scene(), 2, VERBATIM),
    "mesh_fixed": (lambda: mesh.make_scene(), 1, FIXED),
    "mesh_moved_vertex_two_lights": (_moved_vertex_mesh, 1, FIXED),
    "bigmesh_verbatim": (lambda: bigmesh.make_scene(), 1, VERBATIM),
    "bigmesh_spp2": (lambda: bigmesh.make_scene(), 2, VERBATIM),
    "bigmesh_fixed": (lambda: bigmesh.make_scene(), 1, FIXED),
    "bigmesh_ground_grid": (lambda: bigmesh.make_scene(params=bigmesh.default_params(ground_grid=4)), 1, VERBATIM),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_mesh_kernel_code_matches_plain_version(host_lib, case):
    """32x24, depth 4, per pixel within the image gate."""
    make, spp, quirks = CASES[case]
    scene = make()
    key = rng.prng_key(sorted(CASES).index(case) + 31)
    img = host_render(host_lib, scene, key, 32, 24, spp, quirks).numpy()
    ref = MK.render_frame_reference(scene, key, 32, 24, spp, quirks).numpy()
    assert np.isfinite(img).all()
    diff = np.abs(img.astype(np.float64) - ref)
    assert np.quantile(diff, 0.999) < 1e-4
    assert diff.mean() < 1e-5
