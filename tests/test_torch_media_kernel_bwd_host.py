"""The media instantiation of the backward megakernel's per-thread code,
compiled for the host and held to the autograd of its plain PyTorch version.

`record_sample<B, MEDIA = true>` and `adjoint_sample<B, true>`
(csrc/tracer_adj.cuh: media_bounce's path recorded with the carried medium
and whether each bounce scattered, then media_bounce_adj from the records:
the segment's Absorb and Emissive terms, the Scatter event with its
HG-phase NEE, the medium's cotangent carried through the reverse sweep and
landing on the hit material's 26-scalar record on a transmission) are plain
C++ behind the shim of tests/test_torch_kernel_host.py, so g++ builds them
for the analytical, SDF and mesh backends, and a host loop runs the record
step and then the adjoint step for every pixel and sample as K2's two
kernels' threads do (HOST_BACKWARD), on the packed vector with 26-scalar
material records that ops/megakernel hands the kernel. The records' carries
and media are held bit for bit to what tracer.cuh's media_bounce hands on
(on the mesh's coplanar faces too: the record's winner is K1's triangle).
The plain version is
`ops/megakernel.render_grad_reference`, autograd of the eager frame rendered
from the same packed vector under the detached-sampling estimator.

The scenes are tests/test_medium.py's glass demo filled with each medium,
and the lit-medium case (test_torch_media_kernel_host.lit_scene): the light
inside the glass sphere and shadow rays that stop at it, so that the scatter
points' HG-phase NEE contributes (in the closed glass demo every shadow ray
from a scatter point meets the sphere's own wall, and the anisotropy's
gradient is 0). The mesh demo's coplanar-tie pixels
(test_torch_media_kernel_host.py) are left out of the mesh case and
counted: their cotangent is zeroed on both sides.

Tolerance: test_torch_kernel_bwd_host.py's (entries above 1e-3 max|ref|
within rtol 5e-3, the rest within 1e-3 max|ref|). Structural zeros are
asserted exactly: the Scatter density's entry (the free flight is
detached) and the medium entries of the materials without a medium.
Lane by lane, `hg_phase_adj` and the scatter point's NEE adjoint are held to
autograd of `ops/sampling.hg_phase` and `integrator/tracer.
scatter_direct_light` in float64 terms at float32 rounding.
"""

import ctypes

import numpy as np
import pytest
import torch

from pathtracer_tpu_torch.integrator import tracer as T
from pathtracer_tpu_torch.integrator.inverse import named_leaves
from pathtracer_tpu_torch.integrator.tracer import FIXED, VERBATIM
from pathtracer_tpu_torch.models import families
from pathtracer_tpu_torch.models.material import MediumType
from pathtracer_tpu_torch.ops import megakernel as MK
from pathtracer_tpu_torch.ops import rng, sampling
from pathtracer_tpu_torch.ops.vecmath import V3
from test_torch_kernel_bwd_host import HOST_BACKWARD, assert_carries_equal, assert_grad_close, record_carries
from test_torch_kernel_host import PRELUDE, build_shim, launch_keys, one_torch_thread  # noqa: F401
from test_torch_media_kernel_host import DEMO, coplanar_ties, lit_scene, media_scene
from test_torch_sdf_kernel_bwd_host import assert_lanes_close, f32

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SHIM = PRELUDE + r"""
#include "analytical_adj.cuh"
#include "mesh_adj.cuh"
#include "sdf_adj.cuh"
#include "tracer_adj.cuh"
""" + HOST_BACKWARD + r"""

// K2's two kernels of the media instantiation, in turn.
template <class B>
static void grad(const pt::SceneView& s, const uint32_t* keys, const float* ct, float* out, int width, int height,
                 int spp, int depth, int flags) {
  host_backward<B, true>(s, keys, ct, out, width, height, spp, depth, flags);
}

#define HEAD const float *sv, const uint32_t *keys, const float *ct, float *out, int width, int height, int spp, \
             int depth, int n_lights, int n_materials, int flags
#define ARGS keys, ct, out, width, height, spp, depth, flags

extern "C" void host_grad_media(HEAD) {
  grad<pt::AnalyticalAdj>(pt::analytical_view(sv, n_lights, n_materials, (flags & pt::FLAG_RESPECT_MAX_DIST) != 0),
                          ARGS);
}

extern "C" void host_grad_media_sdf(HEAD, int n_spheres, int n_boxes, int n_tori) {
  grad<pt::SdfAdj>(pt::sdf_view(sv, n_lights, n_materials, n_spheres, n_boxes, n_tori), ARGS);
}

extern "C" void host_grad_media_mesh(HEAD, const int* topo, int n_tris, int n_verts) {
  grad<pt::MeshAdj>(pt::mesh_view(sv, n_lights, n_materials, topo, n_tris, n_verts), ARGS);
}

#define CARRIES_HEAD const float *sv, const uint32_t *keys, int width, int height, int spp, int depth, int n_lights, \
                     int n_materials, int flags, float *rec_carry, float *ref_carry, int *rec_len, int *ref_len
#define CARRIES_ARGS keys, width, height, spp, depth, flags, rec_carry, ref_carry, rec_len, ref_len

extern "C" void host_carries_media(CARRIES_HEAD) {
  host_carries<pt::AnalyticalAdj, true>(
      pt::analytical_view(sv, n_lights, n_materials, (flags & pt::FLAG_RESPECT_MAX_DIST) != 0), CARRIES_ARGS);
}

extern "C" void host_carries_media_sdf(CARRIES_HEAD, int n_spheres, int n_boxes, int n_tori) {
  host_carries<pt::SdfAdj, true>(pt::sdf_view(sv, n_lights, n_materials, n_spheres, n_boxes, n_tori), CARRIES_ARGS);
}

extern "C" void host_carries_media_mesh(CARRIES_HEAD, const int* topo, int n_tris, int n_verts) {
  host_carries<pt::MeshAdj, true>(pt::mesh_view(sv, n_lights, n_materials, topo, n_tris, n_verts), CARRIES_ARGS);
}

// Lane i: hg_phase_adj at (cos[i], g[i]) for the cotangent ct[i].
extern "C" void host_hg_phase_adj(int n, const float* cos, const float* g, const float* ct, float* c_cos,
                                  float* c_g) {
  for (int i = 0; i < n; ++i) {
    c_cos[i] = 0.0f;
    c_g[i] = 0.0f;
    pt::hg_phase_adj(cos[i], g[i], ct[i], c_cos[i], c_g[i]);
  }
}

// Lane i: the scatter point's NEE (its record, nee_record, then
// media_direct_light_adj with `phase`) at pos[i] along rd[i] with
// anisotropy g[i] and uniforms u[3 i..]; writes
// ld[i], the cotangents of rd and g for ct[i], and adds the packed scene's
// into grad.
extern "C" void host_phase_nee_adj(const float* sv, int n_lights, int n_materials, int flags, int n, const float* pos,
                                   const float* rd, const float* g, const float* u, const float* ct, float* ld,
                                   float* c_rd, float* c_g, float* grad) {
  const pt::SceneView s = pt::analytical_view(sv, n_lights, n_materials, (flags & pt::FLAG_RESPECT_MAX_DIST) != 0);
  const pt::GradSink sink = {grad, 1};
  for (int i = 0; i < n; ++i) {
    pt::MatAdj a = pt::zero_mat_adj();
    float c_eta = 0.0f, cg = 0.0f;
    pt::V3 crd = pt::splat3(0.0f), cn = pt::splat3(0.0f);
    const pt::V3 r = pt::v3(rd[3 * i], rd[3 * i + 1], rd[3 * i + 2]);
    const pt::V3 x = pt::v3(pos[3 * i], pos[3 * i + 1], pos[3 * i + 2]);
    const pt::BounceHit h = {0.0f, 0.0f, 0, pt::nee_record<pt::AnalyticalAdj>(s, x, u[3 * i], u[3 * i + 1], u[3 * i + 2])};
    const pt::V3 l = pt::media_direct_light_adj(s, r, x, pt::splat3(0.0f), pt::default_material(), 1.0f, true, g[i],
                                                h, u[3 * i + 1], u[3 * i + 2],
                                                pt::v3(ct[3 * i], ct[3 * i + 1], ct[3 * i + 2]), a, c_eta, crd, cn, cg,
                                                sink);
    ld[3 * i] = l.x;
    ld[3 * i + 1] = l.y;
    ld[3 * i + 2] = l.z;
    c_rd[3 * i] = crd.x;
    c_rd[3 * i + 1] = crd.y;
    c_rd[3 * i + 2] = crd.z;
    c_g[i] = cg;
  }
}
"""

ENTRY = {"analytical": "host_grad_media", "sdf": "host_grad_media_sdf", "mesh": "host_grad_media_mesh"}


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    lib = build_shim(tmp_path_factory.mktemp("media_kernel_bwd_host"), SHIM)
    p, i = ctypes.c_void_p, ctypes.c_int
    head = [p, p, p, p, i, i, i, i, i, i, i]
    lib.host_grad_media.argtypes = head
    lib.host_grad_media_sdf.argtypes = head + [i, i, i]
    lib.host_grad_media_mesh.argtypes = head + [p, i, i]
    carries = [p, p, i, i, i, i, i, i, i, p, p, p, p]
    lib.host_carries_media.argtypes = carries
    lib.host_carries_media_sdf.argtypes = carries + [i, i, i]
    lib.host_carries_media_mesh.argtypes = carries + [p, i, i]
    lib.host_hg_phase_adj.argtypes = [i] + [p] * 5
    lib.host_phase_nee_adj.argtypes = [p, i, i, i, i] + [p] * 9
    return lib


def host_grad(lib, scene, key, ct, w, h, spp, quirks):
    """What launch_backward hands K2's MEDIA instantiation, run on the host:
    (the packed vector, d(<ct, frame>)/d(sv) [1, P])."""
    family = families.family_of(scene)
    b = MK.BACKENDS[family]
    # held: the library reads their memory
    sv, keys, ct, extras = b.pack(scene, w, h, True).contiguous(), launch_keys(key, spp), ct.contiguous(), \
        b.extras(scene)
    grad = torch.zeros(sv.shape[1], dtype=torch.float32)
    getattr(lib, ENTRY[family])(
        sv.data_ptr(), keys.data_ptr(), ct.data_ptr(), grad.data_ptr(), w, h, spp, scene.recursion_depth,
        scene.num_lights, int(scene.params.materials.roughness.shape[0]), MK.kernel_flags(scene, quirks),
        *(t.data_ptr() for t in extras), *b.counts(scene),
    )
    return sv, grad[None]


def medium_at(scene, w, h, i: int) -> int:
    """Where material i's medium (density, color, anisotropy) starts in the
    scene's packed vector with 26-scalar records."""
    sv = MK.BACKENDS[families.family_of(scene)].pack(scene, w, h, True).reshape(-1)
    n_mat = int(scene.params.materials.roughness.shape[0])
    return sv.shape[0] - 26 * n_mat + 26 * i + 21


def glass(med_type, **medium):
    return lambda: media_scene("analytical", med_type, **medium)


ANALYTICAL = {
    "absorb": glass(MediumType.ABSORB, **DEMO),
    "emissive": glass(MediumType.EMISSIVE, density=0.5, color=(0.2, 0.8, 0.3)),
    "scatter": glass(MediumType.SCATTER, anisotropy=0.4, **DEMO),
    "scatter_g0": glass(MediumType.SCATTER, density=2.0, color=(1.0, 1.0, 1.0)),
}
# case -> (scene, spp, quirks)
CASES = {f"{name}_spp{spp}_{q}": (make, spp, quirks) for name, make in ANALYTICAL.items()
         for spp in (1, 2) for q, quirks in (("verbatim", VERBATIM), ("fixed", FIXED))}
CASES.update({
    "sdf_scatter": (lambda: media_scene("sdf", MediumType.SCATTER, anisotropy=0.4, **DEMO), 1, VERBATIM),
    "mesh_scatter": (lambda: media_scene("mesh", MediumType.SCATTER, anisotropy=0.4, **DEMO), 1, VERBATIM),
    "lit": (lambda: lit_scene(MediumType.SCATTER, anisotropy=0.4, **DEMO), 1, VERBATIM),
    "lit_spp2_fixed": (lambda: lit_scene(MediumType.SCATTER, anisotropy=0.4, **DEMO), 2, FIXED),
})
W, H = 24, 16


@pytest.mark.parametrize("case", sorted(CASES))
def test_media_backward_code_matches_autograd(host_lib, case):
    """Every entry of the packed gradient, at 24x16, depth 6."""
    make, spp, quirks = CASES[case]
    scene = make()
    seed = sorted(CASES).index(case) + 71
    key = rng.prng_key(seed)
    ct = torch.from_numpy(np.random.default_rng(seed).standard_normal((H, W, 4)).astype(np.float32))
    ties = torch.from_numpy(coplanar_ties(scene, key, W, H, spp, quirks))
    assert int(ties.sum()) <= 0.05 * W * H
    ct = ct * (~ties)[..., None]
    sv, g = host_grad(host_lib, scene, key, ct, W, H, spp, quirks)
    ref = MK.render_grad_reference(sv, scene, key, ct, W, H, spp, quirks)
    assert_grad_close(g, ref)
    # structural zeros: the medium-free materials' media, the Scatter density
    mat = scene.params.materials
    g = g.reshape(-1)
    for i in range(int(mat.roughness.shape[0])):
        at = medium_at(scene, W, H, i)
        if int(mat.medium.medium_type[i]) == 0:
            assert not g[at:at + 5].any(), (i, g[at:at + 5])
        elif int(mat.medium.medium_type[i]) == MediumType.SCATTER:
            assert g[at] == 0.0
    glass_at = medium_at(scene, W, H, {"sdf": 0}.get(families.family_of(scene), 1))
    assert float(g[glass_at + 1:glass_at + 4].abs().max()) > 0  # the color reaches the medium's record


@pytest.mark.parametrize("case", ["absorb_spp1_verbatim", "emissive_spp2_fixed", "lit", "mesh_scatter",
                                  "scatter_spp2_verbatim", "sdf_scatter"])
def test_media_records_carry_what_media_bounce_hands_on(host_lib, case):
    """K2 MEDIA's record step writes, bounce by bounce, the carry and the
    medium tracer.cuh's media_bounce hands on, bit for bit (the mesh's
    coplanar faces included: the winner is K1's first minimum)."""
    make, spp, quirks = CASES[case]
    scene = make()
    family = families.family_of(scene)
    b = MK.BACKENDS[family]
    sv, keys, extras = b.pack(scene, W, H, True).contiguous(), launch_keys(rng.prng_key(sorted(CASES).index(case) + 71),
                                                                            spp), b.extras(scene)
    head = (sv.data_ptr(), keys.data_ptr(), W, H, spp, scene.recursion_depth, scene.num_lights,
            int(scene.params.materials.roughness.shape[0]), MK.kernel_flags(scene, quirks))
    tail = (*(t.data_ptr() for t in extras), *b.counts(scene))
    entry = getattr(host_lib, ENTRY[family].replace("grad", "carries"))
    rec, ref, rec_len, ref_len = record_carries(lambda *a: entry(*a, *tail), head, W, H, spp, scene.recursion_depth,
                                                20)
    assert_carries_equal(rec, ref, rec_len, ref_len, min_bounces=4)
    assert bool((rec[..., 14] > 0).any())  # some bounces travel inside the medium


@pytest.mark.parametrize("med_type", [MediumType.ABSORB, MediumType.EMISSIVE])
def test_segment_that_ends_on_the_light(host_lib, med_type):
    """A segment inside an Absorb or Emissive medium that ends on the light
    inside it: seg is the light's distance, whose cotangent reaches the
    light's position and radius."""
    scene = lit_scene(MediumType.SCATTER, anisotropy=0.4, **DEMO)
    with torch.no_grad():
        scene.params.materials.medium.medium_type[1] = int(med_type)
    key = rng.prng_key(90 + int(med_type))
    ct = torch.from_numpy(np.random.default_rng(int(med_type)).standard_normal((H, W, 4)).astype(np.float32))
    sv, g = host_grad(host_lib, scene, key, ct, W, H, 1, VERBATIM)
    ref = MK.render_grad_reference(sv, scene, key, ct, W, H, 1, VERBATIM)
    assert_grad_close(g, ref)
    assert float(g[0, [37, 38, 39, 49]].abs().max()) > 0  # the light's position and radius


def test_lit_medium_reaches_anisotropy_and_light(host_lib):
    """The lit case's scatter points see the light: the anisotropy's and
    the light emission's entries are non-zero, as the plain version's."""
    scene = lit_scene(MediumType.SCATTER, anisotropy=0.4, **DEMO)
    key = rng.prng_key(3)
    ct = torch.from_numpy(np.random.default_rng(3).standard_normal((H, W, 4)).astype(np.float32))
    sv, g = host_grad(host_lib, scene, key, ct, W, H, 1, VERBATIM)
    ref = MK.render_grad_reference(sv, scene, key, ct, W, H, 1, VERBATIM)
    at = medium_at(scene, W, H, 1)
    for got in (g.reshape(-1), ref.reshape(-1)):
        assert abs(float(got[at + 4])) > 1e-6  # anisotropy
        assert float(got[37 + 3:37 + 6].abs().max()) > 1e-6  # the light's emission
    np.testing.assert_allclose(g[0, at + 4].item(), ref[0, at + 4].item(), rtol=5e-3)


@pytest.mark.parametrize("g", [-0.3, 0.0, 0.4, 0.89])
def test_hg_phase_adjoint_matches_autograd(host_lib, g):
    n = 512
    rs = np.random.default_rng(int(1000 * g) + 1007)
    cos = f32(rs.uniform(-1.0, 1.0, n))
    gs, ct = f32(np.full(n, g)), f32(rs.standard_normal(n))
    c_cos, c_g = torch.zeros(n), torch.zeros(n)
    host_lib.host_hg_phase_adj(n, cos.data_ptr(), gs.data_ptr(), ct.data_ptr(), c_cos.data_ptr(), c_g.data_ptr())
    x = cos.double().requires_grad_(True)
    y = gs.double().requires_grad_(True)
    (sampling.hg_phase(x, y) * ct.double()).sum().backward()
    assert_lanes_close(torch.stack([c_cos, c_g], 1).numpy(), torch.stack([x.grad, y.grad], 1).numpy(), "hg_phase")


def test_phase_nee_adjoint_matches_autograd(host_lib):
    """The scatter point's NEE, lane by lane: its value, and the cotangents
    of rd, g and the light's emission, against autograd of
    tracer.scatter_direct_light (the light sample detached) on the lit
    scene, from points inside the glass sphere around the light."""
    scene = lit_scene(MediumType.SCATTER, anisotropy=0.4, **DEMO)
    n = 256
    rs = np.random.default_rng(11)
    unit = lambda a: a / np.linalg.norm(a, axis=1, keepdims=True)
    pos = f32(np.array([1.1, 0.0, 0.0]) + unit(rs.standard_normal((n, 3))) * rs.uniform(0.35, 0.9, (n, 1)))
    rd = f32(unit(rs.standard_normal((n, 3))))
    gs = f32(rs.uniform(-0.8, 0.8, n))
    u = f32(rs.uniform(0.0, 1.0, (n, 3)))
    ct = f32(rs.standard_normal((n, 3)))
    sv = MK.pack_scene(scene, 8, 8, True).contiguous()
    ld, c_rd, c_g, grad = torch.zeros((n, 3)), torch.zeros((n, 3)), torch.zeros(n), torch.zeros(sv.shape[1])
    host_lib.host_phase_nee_adj(sv.data_ptr(), scene.num_lights, 3, MK.kernel_flags(scene, VERBATIM), n,
                                pos.data_ptr(), rd.data_ptr(), gs.data_ptr(), u.data_ptr(), ct.data_ptr(),
                                ld.data_ptr(), c_rd.data_ptr(), c_g.data_ptr(), grad.data_ptr())
    leaves = dict(named_leaves(scene))
    emission = [leaves[f"lights.emission.{c}"] for c in "xyz"]
    for c in emission:
        c.requires_grad_(True)
    r = rd.clone().requires_grad_(True)
    g = gs.clone().requires_grad_(True)
    ref = T.scatter_direct_light(scene, V3(r[:, 0], r[:, 1], r[:, 2]), V3(pos[:, 0], pos[:, 1], pos[:, 2]), g, u,
                                 detach=True)
    ref = torch.stack([ref.x, ref.y, ref.z], 1)
    grads = torch.autograd.grad((ref * ct).sum(), [r, g, *emission])
    lit = ref.abs().sum(1) > 0
    assert 0.2 < float(lit.double().mean()) < 1.0  # some points see the light, some are shadowed
    assert_lanes_close(ld.numpy(), ref.detach().numpy(), "ld")
    assert_lanes_close(torch.cat([c_rd, c_g[:, None]], 1).numpy(),
                       torch.cat([grads[0], grads[1][:, None]], 1).numpy(), "c_rd, c_g")
    np.testing.assert_allclose(grad[40:43].numpy(), torch.cat(grads[2:]).numpy(), rtol=1e-4)
