"""The media instantiation of the CUDA megakernel's per-thread code,
compiled for the host and held to its plain PyTorch version.

`trace_sample<B, COUNT, MEDIA = true>` (csrc/tracer.cuh: the segment inside
a medium, the Scatter event with its HG-phase NEE and continuation, the
medium transition) is plain C++ behind the shim of
tests/test_torch_kernel_host.py, so g++ builds it with -ffp-contract=off
for the analytical, SDF, mesh and big mesh backends, and a host loop runs
it for every pixel as K1's (and, with COUNT, K3's) threads do, on the
packed vector with 26-scalar material records that ops/megakernel hands
the kernel. Each frame is held per pixel to the plain version (the eager
integrator) within chip_smoke.py's image gate, and K3's counts to
`tracer.bounces_entered` lane for lane. The card run checks what nvcc
makes of it.

The mesh demo's glass cube stands on the floor: its bottom face and the
floor are coplanar, so a path inside the cube that reaches the bottom meets
two triangles at one t, and the first minimum that wins hangs on the last
bit of its origin, which libm's ulps move (`ops/megakernel_mesh.hit_ties`).
The mesh cases leave those pixels out of the gate and count them.
This module imports no JAX (tests/test_torch_kernel_cuda.py takes its
scenes).
"""

import ctypes

import numpy as np
import pytest
import torch

from pathtracer_tpu_torch.integrator import tracer as T
from pathtracer_tpu_torch.integrator.tracer import FIXED, VERBATIM
from pathtracer_tpu_torch.models import families
from pathtracer_tpu_torch.models.material import MediumType
from pathtracer_tpu_torch.ops import megakernel as MK
from pathtracer_tpu_torch.ops import rng
from pathtracer_tpu_torch.ops.megakernel_mesh import hit_ties
from test_torch_kernel_host import MESH_VIEW, PRELUDE, TILED, build_shim, launch_keys, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SHIM = PRELUDE + r"""
#include "analytical.cuh"
#include "bigmesh.cuh"
#include "mesh.cuh"
#include "sdf.cuh"
#include "tracer.cuh"
""" + MESH_VIEW + r"""
""" + TILED + r"""
// K1's (K3's with `entered`) threads of the media instantiation, in turn;
// with `tiled`, the compacted schedule (TILED, its lists shuffled from
// `seed`, `entered` required).
template <class B>
static void frame(const pt::SceneView& s, const uint32_t* keys, float* out, int* entered, int width, int height,
                  int spp, int depth, int flags, int tiled, uint32_t seed) {
  if (tiled) return tiled_frame<B, true>(s, keys, out, entered, width, height, spp, depth, flags, seed);
  const int n = width * height;
  for (int p = 0; p < n; ++p) {
    pt::V3 sum = pt::splat3(0.0f);
    for (int k = 0; k < spp; ++k) {
      const uint32_t* kk = keys + 4 * k;
      pt::V3 r;
      if (entered) {
        r = pt::trace_sample<B, true, true>(s, p, n, width, height, depth, flags, kk[0], kk[1], kk[2], kk[3],
                                            entered + k * n + p);
      } else {
        r = pt::trace_sample<B, false, true>(s, p, n, width, height, depth, flags, kk[0], kk[1], kk[2], kk[3]);
      }
      sum = k == 0 ? r : sum + r;
    }
    if (spp > 1) sum = sum / (float)spp;
    out[4 * p + 0] = sum.x;
    out[4 * p + 1] = sum.y;
    out[4 * p + 2] = sum.z;
    out[4 * p + 3] = 1.0f;
  }
}

#define HEAD const float *sv, const uint32_t *keys, float *out, int *entered, int width, int height, int spp, \
             int depth, int n_lights, int n_materials, int flags, int tiled, uint32_t seed
#define ARGS keys, out, entered, width, height, spp, depth, flags, tiled, seed

extern "C" void host_media(HEAD) {
  frame<pt::Analytical>(pt::analytical_view(sv, n_lights, n_materials, (flags & pt::FLAG_RESPECT_MAX_DIST) != 0),
                        ARGS);
}

extern "C" void host_media_sdf(HEAD, int n_spheres, int n_boxes, int n_tori) {
  WITH_SDF_COUNTS(n_spheres, n_boxes, n_tori,
                  frame<pt::Sdf<C>>(pt::sdf_view(sv, n_lights, n_materials, n_spheres, n_boxes, n_tori), ARGS));
}

extern "C" void host_media_mesh(HEAD, const int* topo, int n_tris, int n_verts) {
  frame<pt::Mesh>(host_mesh_view(sv, n_lights, n_materials, topo, n_tris, n_verts), ARGS);
}

extern "C" void host_media_bigmesh(HEAD, const float* coef, const float* attr, const float* aabb, int n_chunks) {
  frame<pt::BigMesh>(pt::bigmesh_view(sv, n_lights, n_materials, coef, attr, aabb, n_chunks), ARGS);
}
"""

ENTRY = {"analytical": "host_media", "sdf": "host_media_sdf", "mesh": "host_media_mesh",
         "bigmesh": "host_media_bigmesh"}
# the material each family's demo fills with a medium: a closed shape's
GLASS = {"analytical": 1, "sdf": 0, "mesh": 1, "bigmesh": 1}


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    lib = build_shim(tmp_path_factory.mktemp("media_kernel_host"), SHIM)
    p, i = ctypes.c_void_p, ctypes.c_int
    head = [p, p, p, p, i, i, i, i, i, i, i, i, ctypes.c_uint32]
    lib.host_media.argtypes = head
    lib.host_media_sdf.argtypes = head + [i, i, i]
    lib.host_media_mesh.argtypes = head + [p, i, i]
    lib.host_media_bigmesh.argtypes = head + [p, p, p, i]
    return lib


def host_render(lib, scene, key, w, h, spp, quirks, entered=None, seed=None):
    """What render_frame_megakernel hands K1's media instantiation (K3's
    with `entered`, int32 [spp, H, W]), run on the host; with a `seed`,
    through the compacted schedule (its lists shuffled from it; `entered`
    required)."""
    family = families.family_of(scene)
    b = MK.BACKENDS[family]
    # held: the library reads their memory
    sv, keys, extras = b.pack(scene, w, h, True).contiguous(), launch_keys(key, spp), b.extras(scene)
    out = torch.empty((h, w, 4), dtype=torch.float32)
    getattr(lib, ENTRY[family])(
        sv.data_ptr(), keys.data_ptr(), out.data_ptr(), None if entered is None else entered.data_ptr(), w, h, spp,
        scene.recursion_depth, scene.num_lights, int(scene.params.materials.roughness.shape[0]),
        MK.kernel_flags(scene, quirks), int(seed is not None), seed or 0, *(t.data_ptr() for t in extras),
        *b.counts(scene),
    )
    return out


# The demo's medium (tests/test_medium.py's glass sphere holds it).
DEMO = dict(density=0.8, color=(0.9, 0.2, 0.1))


def make_glass(scene, i: int, med_type=None, density=0.8, color=(0.9, 0.2, 0.1), anisotropy=0.0):
    """`scene` with material i made glass (spec_trans 1, metallic 0,
    roughness 0.05, ior 1.5), filled with a medium when med_type is given
    (in place)."""
    m = scene.params.materials
    with torch.no_grad():
        m.spec_trans[i], m.metallic[i], m.roughness[i], m.ior[i] = 1.0, 0.0, 0.05, 1.5
        if med_type is not None:
            med = m.medium
            med.medium_type[i], med.density[i], med.anisotropy[i] = med_type, density, anisotropy
            med.color.x[i], med.color.y[i], med.color.z[i] = color
    return scene


def media_scene(family, med_type, depth=6, device=None, **medium):
    """The family's demo with its GLASS material glass and filled."""
    scene = families.make_family_scene(family, recursion_depth=depth, device=device)
    return make_glass(scene, GLASS[family], med_type, **medium)


# The light of the lit-medium case: inside sphere 1, at its center.
LIT_LIGHT = dict(position=(1.1, 0.0, 0.0), radius=0.25, emission=(3.0, 3.0, 3.0))


def lit_scene(med_type, dtype=torch.float32, depth=6, device=None, **medium):
    """The analytical glass demo filled with a medium around the light
    (LIT_LIGHT), with shadow rays that stop at the light, so that a scatter
    point sees it (in the closed glass demo every shadow ray from inside
    the sphere meets its wall)."""
    from pathtracer_tpu_torch.models.analytical import make_scene
    from pathtracer_tpu_torch.models.light import spherical_light

    scene = make_scene(dtype=dtype, recursion_depth=depth, respect_max_dist=True,
                       lights=spherical_light(**LIT_LIGHT, dtype=dtype, device=device), device=device)
    return make_glass(scene, GLASS["analytical"], med_type, **medium)
# case -> (family, medium type, medium kwargs, spp, quirks, width, height)
CASES = {
    "absorb": ("analytical", MediumType.ABSORB, DEMO, 1, VERBATIM, 96, 64),
    "absorb_fixed": ("analytical", MediumType.ABSORB, dict(density=2.0, color=(0.3, 0.6, 0.9)), 1, FIXED, 96, 64),
    "emissive": ("analytical", MediumType.EMISSIVE, dict(density=0.5, color=(0.2, 0.8, 0.3)), 1, VERBATIM, 96, 64),
    "emissive_spp2_fixed": ("analytical", MediumType.EMISSIVE, DEMO, 2, FIXED, 96, 64),
    "scatter": ("analytical", MediumType.SCATTER, dict(anisotropy=0.4, **DEMO), 1, VERBATIM, 96, 64),
    "scatter_spp2": ("analytical", MediumType.SCATTER, dict(anisotropy=0.4, **DEMO), 2, VERBATIM, 96, 64),
    "scatter_fixed": ("analytical", MediumType.SCATTER, dict(anisotropy=0.4, **DEMO), 1, FIXED, 96, 64),
    "scatter_g0": ("analytical", MediumType.SCATTER, dict(density=2.0, color=(1.0, 1.0, 1.0)), 1, VERBATIM, 96, 64),
    "scatter_g-0.3_fixed": ("analytical", MediumType.SCATTER, dict(density=1.5, color=(0.8, 0.8, 0.9),
                                                                   anisotropy=-0.3), 1, FIXED, 96, 64),
    "sdf_scatter": ("sdf", MediumType.SCATTER, dict(anisotropy=0.4, **DEMO), 1, VERBATIM, 32, 24),
    "sdf_absorb_fixed": ("sdf", MediumType.ABSORB, DEMO, 1, FIXED, 32, 24),
    "mesh_scatter": ("mesh", MediumType.SCATTER, dict(anisotropy=0.4, **DEMO), 1, VERBATIM, 48, 32),
    "mesh_emissive_fixed": ("mesh", MediumType.EMISSIVE, DEMO, 1, FIXED, 48, 32),
    "bigmesh_scatter_g0": ("bigmesh", MediumType.SCATTER, dict(density=2.0, color=(1.0, 1.0, 1.0)), 1, VERBATIM,
                           48, 32),
}


def coplanar_ties(scene, key, w, h, spp, quirks) -> np.ndarray:
    """[H, W]: the pixels whose plain path meets two coplanar triangles at
    once (none off the small mesh)."""
    if families.family_of(scene) != "mesh":
        return np.zeros((h, w), bool)
    return (hit_ties(scene, key, w, h, spp, quirks) < 1e-6).any(1).any(0).reshape(h, w).numpy()


@pytest.mark.parametrize("case", sorted(CASES))
def test_media_kernel_code_matches_plain_version(host_lib, case):
    """Per pixel within the image gate, depth 6, the pixels of a coplanar
    tie left out (and counted: 44 and 62 of 1536 in the mesh cases)."""
    family, med_type, medium, spp, quirks, w, h = CASES[case]
    scene = media_scene(family, med_type, **medium)
    key = rng.prng_key(sorted(CASES).index(case) + 51)
    img = host_render(host_lib, scene, key, w, h, spp, quirks).numpy()
    ref = MK.render_frame_reference(scene, key, w, h, spp, quirks).numpy()
    assert np.isfinite(img).all()
    ties = coplanar_ties(scene, key, w, h, spp, quirks)
    assert ties.mean() < 0.05
    diff = np.abs(img.astype(np.float64) - ref)[~ties]
    assert np.quantile(diff, 0.999) < 1e-4
    assert diff.mean() < 1e-5


def test_media_render_differs_from_vacuum(host_lib):
    """The media instantiation reads the medium: the same glass without
    one renders another frame."""
    key = rng.prng_key(50)
    scat = host_render(host_lib, media_scene("analytical", MediumType.SCATTER, anisotropy=0.4, **DEMO), key, 32, 24,
                       1, VERBATIM)
    scene = media_scene("analytical", MediumType.SCATTER, anisotropy=0.4, **DEMO)
    with torch.no_grad():
        scene.params.materials.medium.density.zero_()  # a Scatter medium of density 0 scatters nothing
    vacuum = host_render(host_lib, scene, key, 32, 24, 1, VERBATIM)
    assert not torch.equal(scat, vacuum)
    assert torch.equal(vacuum, host_render(host_lib, media_scene("analytical", MediumType.NONE), key, 32, 24, 1,
                                           VERBATIM))


@pytest.mark.parametrize("family", ["analytical", "mesh"])
def test_media_counts_match_bounces_entered(host_lib, family):
    """K3's media instantiation: the bounces each lane entered alive, as
    tracer.bounces_entered counts them, and K1's frame bit for bit."""
    scene = media_scene(family, MediumType.SCATTER, anisotropy=0.4, **DEMO)
    key = rng.prng_key(4)
    entered = torch.zeros((2, 24, 32), dtype=torch.int32)
    img = host_render(host_lib, scene, key, 32, 24, 2, VERBATIM, entered)
    ties = torch.from_numpy(coplanar_ties(scene, key, 32, 24, 2, VERBATIM))
    want = T.bounces_entered(scene, key, 32, 24, 2)
    assert torch.equal(entered[:, ~ties], want[:, ~ties])
    assert torch.equal(img, host_render(host_lib, scene, key, 32, 24, 2, VERBATIM))


@pytest.mark.parametrize("case", sorted(CASES))
def test_media_compacted_schedule_matches_per_thread_loop(host_lib, case):
    """The compacted K1's schedule of the MEDIA instantiation, its lists in
    a shuffled order and the scatter points before the surfaces, on frames
    3 pixels wider and one taller than the cases' (so that the last tile of
    256 paths is part empty): each pixel's radiance and K3 counts bit for
    bit the per-thread loop's (trace_sample), and within the plain
    version's image gate, the mesh's coplanar ties left out as above. 0.1-3.9 s a case, most of it the plain
    version's."""
    family, med_type, medium, spp, quirks, w, h = CASES[case]
    w, h = w + 3, h + 1
    scene = media_scene(family, med_type, **medium)
    key = rng.prng_key(sorted(CASES).index(case) + 51)
    seed = int(np.random.default_rng(100 + sorted(CASES).index(case)).integers(2**32))
    entered, want = (torch.zeros((spp, h, w), dtype=torch.int32) for _ in range(2))
    img = host_render(host_lib, scene, key, w, h, spp, quirks, entered, seed)
    assert torch.equal(img, host_render(host_lib, scene, key, w, h, spp, quirks, want))
    assert torch.equal(entered, want)
    ref = MK.render_frame_reference(scene, key, w, h, spp, quirks).numpy()
    ties = coplanar_ties(scene, key, w, h, spp, quirks)
    diff = np.abs(img.numpy().astype(np.float64) - ref)[~ties]
    assert np.quantile(diff, 0.999) < 1e-4
    assert diff.mean() < 1e-5
