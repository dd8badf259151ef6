"""The backward megakernel's per-thread code, compiled for the host and held
to the autograd of its plain PyTorch version.

`csrc/tracer_adj.cuh` (the hand-written record and adjoint steps of one
sample of one pixel) and the adjoint headers under it are plain C++ apart
from the CUDA qualifiers, so g++ builds them behind the shim of
test_torch_kernel_host.py. A host loop runs K2's two kernels as their
threads do (HOST_BACKWARD): `record_sample` for every pixel and sample,
writing the records in the kernels' [sample][bounce][word][pixel] layout,
then `adjoint_sample` for every pixel and sample from those records, summing
d(<ct, frame>)/d(sv); the plain version is
`ops/megakernel.render_grad_reference`, torch autograd of the eager frame
rendered from the same packed scene vector sv under the detached-sampling
estimator. The records' carries are held bit for bit to what tracer.cuh's
bounce hands on. The BSDF adjoints, the most intricate pieces, are also
held to autograd of `ops/bsdf` on their own, lane by lane.

Tolerance (gradients): entries above 1e-3 max|ref| within rtol 5e-3, the
others within 1e-3 max|ref|. Both sides are float32 and sum over pixels in
another order. Lane by lane, the BSDF adjoints agree to 1e-3 of each
lane's largest cotangent.
"""

import ctypes
import os

import numpy as np
import pytest
import torch

from pathtracer_tpu_torch.integrator.tracer import FIXED, VERBATIM
from pathtracer_tpu_torch.models.analytical import default_params, make_scene
from pathtracer_tpu_torch.models.material import finalize_material, make_material, stack_materials
from pathtracer_tpu_torch.ops import bsdf, rng
from pathtracer_tpu_torch.ops import megakernel as MK
from pathtracer_tpu_torch.ops.pack import MAT_FIELDS
from pathtracer_tpu_torch.ops.vecmath import V3
from test_torch_kernel_host import PRELUDE, _alpha_glass_params, _three_lights, build_shim, launch_keys
from test_torch_kernel_host import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# The host build's analytical gradients before K2 became generic over the
# scene backend (the same cases, seeds and cotangents as below, at 32x16,
# and at 320x240 for depth 4, spp 1), written by host_grad from the sources
# of that time; keyed "<case>_<W>x<H>".
UNCHANGED = os.path.join(os.path.dirname(__file__), "golden_torch", "k2_host_analytical.npz")

# K2's two kernels on the host, after tracer_adj.cuh and the backend's
# adjoint header: host_backward runs the record step of every pixel and
# sample of a chunk of pixels, then the adjoint step of each pixel, its
# samples in order, as record_kernel's and adjoint_kernel's threads do;
# host_backward_pixel one sample of one pixel; host_carries the carries the
# record step writes beside those tracer.cuh's bounce (media_bounce with
# MEDIA) hands on, each path's bounces in both.
HOST_BACKWARD = r"""
#include <vector>

template <class B, bool MEDIA>
static void host_backward(const pt::SceneView& s, const uint32_t* keys, const float* ct, float* grad, int width,
                          int height, int spp, int depth, int flags) {
  constexpr int W = pt::Record<MEDIA>::WORDS;
  const int n = width * height, chunk = std::min(n, 1 << 16);
  std::vector<float> rec((size_t)spp * depth * W * chunk);
  std::vector<int> lens((size_t)spp * chunk);
  const pt::GradSink g = {grad, 1};
  for (int p0 = 0; p0 < n; p0 += chunk) {
    const int pixels = std::min(chunk, n - p0);
    auto record = [&](int k, int q) { return pt::Record<MEDIA>{rec.data() + (size_t)k * depth * W * pixels + q, pixels}; };
    for (int k = 0; k < spp; ++k) {
      const uint32_t* kk = keys + 4 * k;
      for (int q = 0; q < pixels; ++q) {
        lens[(size_t)k * pixels + q] = pt::record_sample<B, MEDIA>(s, p0 + q, n, width, height, depth, flags, kk[0],
                                                                   kk[1], kk[2], kk[3], record(k, q));
      }
    }
    for (int q = 0; q < pixels; ++q) {
      const int p = p0 + q;
      const pt::V3 c = pt::v3(ct[4 * p] / (float)spp, ct[4 * p + 1] / (float)spp, ct[4 * p + 2] / (float)spp);
      for (int k = 0; k < spp; ++k) {
        const uint32_t* kk = keys + 4 * k;
        pt::adjoint_sample<B, MEDIA>(s, p, n, width, height, flags, kk[0], kk[1], kk[2], kk[3], c, record(k, q),
                                     lens[(size_t)k * pixels + q], g);
      }
    }
  }
}

template <class B, bool MEDIA>
static void host_backward_pixel(const pt::SceneView& s, const uint32_t* kk, pt::V3 ct, float* grad, int p, int width,
                                int height, int depth, int flags) {
  std::vector<float> rec((size_t)depth * pt::Record<MEDIA>::WORDS + 1);
  const pt::Record<MEDIA> r = {rec.data(), 1};
  const int n = width * height;
  const int bounces = pt::record_sample<B, MEDIA>(s, p, n, width, height, depth, flags, kk[0], kk[1], kk[2], kk[3], r);
  pt::adjoint_sample<B, MEDIA>(s, p, n, width, height, flags, kk[0], kk[1], kk[2], kk[3], ct, r, bounces, {grad, 1});
}

// For sample k of pixel p, out[((k n + p) depth + d) words + j]: word j of the
// carry entering bounce d (words = 14, 20 with the medium), first as
// record_sample writes it (rec_carry), then as bounce hands it on
// (ref_carry); rec_len and ref_len the bounces each entered.
template <class B, bool MEDIA>
static void host_carries(const pt::SceneView& s, const uint32_t* keys, int width, int height, int spp, int depth,
                         int flags, float* rec_carry, float* ref_carry, int* rec_len, int* ref_len) {
  constexpr int words = MEDIA ? 20 : 14;
  const int n = width * height;
  std::vector<float> rec((size_t)depth * pt::Record<MEDIA>::WORDS + 1);
  const pt::Record<MEDIA> r = {rec.data(), 1};
  auto put = [&](float* out, int k, int p, int d, const pt::PathCarry& c, const pt::Medium* m) {
    float* o = out + (((size_t)k * n + p) * depth + d) * words;
    const float w[14] = {c.ro.x, c.ro.y, c.ro.z, c.rd.x, c.rd.y, c.rd.z, c.throughput.x, c.throughput.y,
                         c.throughput.z, c.prev_pdf, c.prev_l.x, c.prev_l.y, c.prev_l.z, c.prev_hit_dist};
    for (int j = 0; j < 14; ++j) o[j] = w[j];
    if (m) {
      const float mw[6] = {(float)m->type, m->density, m->color.x, m->color.y, m->color.z, m->aniso};
      for (int j = 0; j < 6; ++j) o[14 + j] = mw[j];
    }
  };
  for (int k = 0; k < spp; ++k) {
    const uint32_t* kk = keys + 4 * k;
    for (int p = 0; p < n; ++p) {
      const int len = pt::record_sample<B, MEDIA>(s, p, n, width, height, depth, flags, kk[0], kk[1], kk[2], kk[3], r);
      rec_len[k * n + p] = len;
      for (int d = 0; d < len; ++d) {
        const pt::PathCarry c = pt::get_carry(r, d);
        if constexpr (MEDIA) {
          const pt::Medium m = pt::get_medium(r, d);
          put(rec_carry, k, p, d, c, &m);
        } else {
          put(rec_carry, k, p, d, c, nullptr);
        }
      }
      pt::V3 q;
      float sx, sy;
      const pt::V3 rd = pt::camera_ray(s, p, width, height, pt::uniform_at(kk[0], kk[1], pt::camera_counter(p, 0)),
                                       pt::uniform_at(kk[0], kk[1], pt::camera_counter(p, 1)), q, sx, sy);
      pt::V3 radiance = pt::splat3(0.0f);
      int entered = 0;
      if constexpr (MEDIA) {
        pt::MediaCarry c;
        static_cast<pt::PathCarry&>(c) = pt::init_carry(s, rd, flags);
        c.med = pt::vacuum();
        for (int d = 0; d < depth; ++d) {
          put(ref_carry, k, p, d, c, &c.med);
          entered = d + 1;
          if (!pt::media_bounce<B>(s, c, radiance, n, p, d, flags, kk[2], kk[3])) break;
        }
      } else {
        pt::PathCarry c = pt::init_carry(s, rd, flags);
        for (int d = 0; d < depth; ++d) {
          put(ref_carry, k, p, d, c, nullptr);
          entered = d + 1;
          if (!pt::bounce<B>(s, c, radiance, n, p, d, flags, kk[2], kk[3])) break;
        }
      }
      ref_len[k * n + p] = entered;
    }
  }
}
"""

SHIM = PRELUDE + r"""
#include "analytical_adj.cuh"
#include "tracer_adj.cuh"
""" + HOST_BACKWARD + r"""
extern "C" void host_grad(const float* sv, const uint32_t* keys, const float* ct, float* grad, int width, int height,
                          int spp, int depth, int n_lights, int n_materials, int flags) {
  host_backward<pt::AnalyticalAdj, false>(
      pt::analytical_view(sv, n_lights, n_materials, (flags & pt::FLAG_RESPECT_MAX_DIST) != 0), keys, ct, grad, width,
      height, spp, depth, flags);
}

extern "C" void host_carries_analytical(const float* sv, const uint32_t* keys, int width, int height, int spp,
                                        int depth, int n_lights, int n_materials, int flags, float* rec_carry,
                                        float* ref_carry, int* rec_len, int* ref_len) {
  host_carries<pt::AnalyticalAdj, false>(
      pt::analytical_view(sv, n_lights, n_materials, (flags & pt::FLAG_RESPECT_MAX_DIST) != 0), keys, width, height,
      spp, depth, flags, rec_carry, ref_carry, rec_len, ref_len);
}

static pt::V3 at3(const float* a, int i) { return pt::v3(a[3 * i], a[3 * i + 1], a[3 * i + 2]); }
static void put3(float* a, int i, pt::V3 v) { a[3 * i] = v.x; a[3 * i + 1] = v.y; a[3 * i + 2] = v.z; }

// Lane i: material record rec[20 i], eta, v_world, n_world and a third
// direction (the light direction of disney_eval, prev_l of disney_sample).
// Writes the cotangents of the raw record, eta, v_world and n_world for
// the given cotangents (of f and the pdf, or of the direction and f).
extern "C" void host_bsdf_adj(int sample, int n, const float* rec, const float* eta, const float* vw, const float* nw,
                              const float* dir, const float* u, const float* ct_a, const float* ct_b, float* c_rec,
                              float* c_eta, float* c_vw, float* c_nw) {
  for (int i = 0; i < n; ++i) {
    const pt::Material raw = pt::load_material(rec + 20 * i);
    pt::Material m = raw;
    pt::finalize_material(m);
    pt::MatAdj a = pt::zero_mat_adj();
    float ce = 0.0f;
    pt::V3 cv = pt::splat3(0.0f), cn = pt::splat3(0.0f);
    if (sample) {
      pt::disney_sample_with_adj(
          m, eta[i], at3(vw, i), at3(nw, i), at3(dir, i), u[3 * i], u[3 * i + 1], u[3 * i + 2],
          [&](const pt::BsdfSample&, pt::V3& c_l, pt::V3& c_f) {
            c_l = at3(ct_a, i);
            c_f = at3(ct_b, i);
            return true;
          },
          a, ce, cv, cn);
    } else {
      pt::disney_eval_with_adj(
          m, eta[i], at3(vw, i), at3(nw, i), at3(dir, i),
          [&](pt::V3, float, pt::V3& c_f, float& c_pdf) {
            c_f = at3(ct_a, i);
            c_pdf = ct_b[3 * i];
            return true;
          },
          a, ce, cv, cn);
    }
    pt::finalize_material_adj(raw, a);
    const pt::GradSink g = {c_rec + 20 * i, 1};
    pt::scatter_material_adj(g, 0, a, true);
    c_eta[i] = ce;
    put3(c_vw, i, cv);
    put3(c_nw, i, cn);
  }
}
"""


@pytest.fixture(scope="module")
def bwd_lib(tmp_path_factory):
    lib = build_shim(tmp_path_factory.mktemp("kernel_bwd_host"), SHIM)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.host_grad.argtypes = [p, p, p, p, i, i, i, i, i, i, i]
    lib.host_carries_analytical.argtypes = [p, p, i, i, i, i, i, i, i, p, p, p, p]
    lib.host_bsdf_adj.argtypes = [i, i] + [p] * 12
    return lib


def assert_grad_close(g, ref):
    g, ref = np.asarray(g, np.float64).ravel(), np.asarray(ref, np.float64).ravel()
    assert np.isfinite(g).all()
    scale = np.abs(ref).max()
    assert scale > 0
    big = np.abs(ref) > 1e-3 * scale
    np.testing.assert_allclose(g[big], ref[big], rtol=5e-3)
    np.testing.assert_allclose(g[~big], ref[~big], rtol=0, atol=1e-3 * scale)


def host_grad(lib, scene, key, ct, w, h, spp, quirks):
    """What the backward megakernel computes from the same inputs, on the host."""
    sv = MK.pack_scene(scene, w, h).contiguous()
    keys, ct = launch_keys(key, spp), ct.contiguous()  # held: the library reads their memory
    grad = torch.zeros(sv.shape[1], dtype=torch.float32)
    lib.host_grad(
        sv.data_ptr(), keys.data_ptr(), ct.data_ptr(), grad.data_ptr(),
        w, h, spp, scene.recursion_depth, scene.num_lights,
        int(scene.params.materials.roughness.shape[0]), MK.kernel_flags(scene, quirks),
    )
    return sv, grad[None]


CASES = {
    f"d{depth}_spp{spp}_{name}": (lambda depth=depth: make_scene(recursion_depth=depth), spp, quirks)
    for depth in (2, 4) for spp in (1, 2) for name, quirks in (("verbatim", VERBATIM), ("fixed", FIXED))
}
CASES.update({
    "three_light_types": (lambda: make_scene(lights=_three_lights()), 1, VERBATIM),
    "alpha_and_transmission": (lambda: make_scene(params=_alpha_glass_params()), 2, FIXED),
    "depth8_respect_max_dist": (lambda: make_scene(recursion_depth=8, respect_max_dist=True), 1, FIXED),
})


@pytest.mark.parametrize("case", sorted(CASES))
def test_backward_code_matches_autograd(bwd_lib, case):
    make, spp, quirks = CASES[case]
    scene = make()
    w, h = 32, 16
    seed = sorted(CASES).index(case) + 21
    key = rng.prng_key(seed)
    ct = torch.from_numpy(np.random.default_rng(seed).standard_normal((h, w, 4)).astype(np.float32))
    sv, grad = host_grad(bwd_lib, scene, key, ct, w, h, spp, quirks)
    ref = MK.render_grad_reference(sv, scene, key, ct, w, h, spp, quirks)
    assert_grad_close(grad, ref)


def record_carries(entry, head, w, h, spp, depth, words):
    """entry(*head, rec_carry, ref_carry, rec_len, ref_len) of HOST_BACKWARD's
    host_carries: the carries the record step writes and those bounce hands
    on, [spp, H*W, depth, words] float32, and the bounces each path entered
    in both, [spp, H*W] int32."""
    rec = torch.zeros((spp, h * w, depth, words), dtype=torch.float32)
    ref = torch.zeros_like(rec)
    rec_len = torch.zeros((spp, h * w), dtype=torch.int32)
    ref_len = torch.zeros_like(rec_len)
    entry(*head, rec.data_ptr(), ref.data_ptr(), rec_len.data_ptr(), ref_len.data_ptr())
    return rec, ref, rec_len, ref_len


def assert_carries_equal(rec, ref, rec_len, ref_len, min_bounces=2):
    """The records' carries bit for bit those bounce hands on, on paths of
    the same length, some of them at least min_bounces long."""
    assert torch.equal(rec_len, ref_len)
    assert int(rec_len.max()) >= min_bounces
    assert torch.equal(rec.view(torch.int32), ref.view(torch.int32))


@pytest.mark.parametrize("case", ["alpha_and_transmission", "d4_spp2_fixed", "depth8_respect_max_dist",
                                  "three_light_types"])
def test_records_carry_what_bounce_hands_on(bwd_lib, case):
    """K2's record step writes, bounce by bounce, the carry tracer.cuh's
    bounce hands on (the one K1 traces), bit for bit."""
    make, spp, quirks = CASES[case]
    scene = make()
    w, h = 32, 16
    sv = MK.pack_scene(scene, w, h).contiguous()
    keys = launch_keys(rng.prng_key(sorted(CASES).index(case) + 21), spp)
    head = (sv.data_ptr(), keys.data_ptr(), w, h, spp, scene.recursion_depth, scene.num_lights,
            int(scene.params.materials.roughness.shape[0]), MK.kernel_flags(scene, quirks))
    assert_carries_equal(*record_carries(bwd_lib.host_carries_analytical, head, w, h, spp, scene.recursion_depth, 14))


def enclosed_scene(depth: int = 20):
    """The demo scene inside sphere 1, grown to radius 20 about the origin:
    the camera, sphere 0, the light and the floor all lie within it, so a
    path ends only on the light or at `depth` (at 16x8, seed 7, a third of
    the paths enter more than 16 bounces)."""
    p = default_params()
    p = p._replace(sphere_center=V3(torch.tensor([-1.1, 0.0]), torch.tensor([0.0, 0.0]), torch.tensor([0.0, 0.0])),
                   sphere_radius=torch.tensor([1.0, 20.0]))
    return make_scene(recursion_depth=depth, params=p)


@pytest.mark.parametrize("quirks", [VERBATIM, FIXED], ids=["verbatim", "fixed"])
def test_deep_paths_match_autograd(bwd_lib, quirks):
    """Depth 20, past the 16 bounces the adjoint once held per thread: the
    records carry what bounce hands on, and the gradient matches autograd
    of the plain version."""
    scene = enclosed_scene()
    w, h, seed = 16, 8, 7
    key = rng.prng_key(seed)
    sv = MK.pack_scene(scene, w, h).contiguous()
    keys = launch_keys(key, 1)
    head = (sv.data_ptr(), keys.data_ptr(), w, h, 1, 20, scene.num_lights,
            int(scene.params.materials.roughness.shape[0]), MK.kernel_flags(scene, quirks))
    assert_carries_equal(*record_carries(bwd_lib.host_carries_analytical, head, w, h, 1, 20, 14), min_bounces=20)
    ct = torch.from_numpy(np.random.default_rng(seed).standard_normal((h, w, 4)).astype(np.float32))
    sv, grad = host_grad(bwd_lib, scene, key, ct, w, h, 1, quirks)
    assert_grad_close(grad, MK.render_grad_reference(sv, scene, key, ct, w, h, 1, quirks))


def _unchanged_keys():
    with np.load(UNCHANGED) as data:
        return sorted(data.files)


@pytest.mark.parametrize("name", _unchanged_keys())
def test_analytical_gradient_is_unchanged_by_the_backend_template(bwd_lib, name):
    """Bit for bit the gradient the analytical instantiation gave before
    the adjoint tracer took the backend as a template parameter."""
    case, size = name.rsplit("_", 1)
    w, h = (int(v) for v in size.split("x"))
    make, spp, quirks = CASES[case]
    seed = sorted(CASES).index(case) + 21
    ct = torch.from_numpy(np.random.default_rng(seed).standard_normal((h, w, 4)).astype(np.float32))
    _, grad = host_grad(bwd_lib, make(), rng.prng_key(seed), ct, w, h, spp, quirks)
    with np.load(UNCHANGED) as want:
        np.testing.assert_array_equal(grad[0].numpy(), want[name])


def _lanes(n, seed):
    """Random material records, eta, unit v/n/third directions, uniforms."""
    rs = np.random.default_rng(seed)
    unit = lambda a: a / np.linalg.norm(a, axis=1, keepdims=True)
    nw = unit(rs.standard_normal((n, 3)))
    vw = unit(nw * rs.uniform(0.2, 1.0, (n, 1)) + unit(rs.standard_normal((n, 3))) * 0.7)
    rec = np.zeros((n, 20))
    rec[:, 0:3] = rs.uniform(0.05, 1.0, (n, 3))
    rec[:, 3] = rs.uniform(0.0, 0.8, n)  # anisotropic
    rec[:, 7] = rs.uniform(0.0, 1.0, n)  # metallic
    rec[:, 8] = rs.uniform(0.05, 1.0, n)  # roughness
    rec[:, 9:15] = rs.uniform(0.0, 1.0, (n, 6))  # subsurface .. clearcoat_gloss
    rec[:, 15] = rs.uniform(0.0, 1.0, n)  # spec_trans
    rec[:, 16] = rs.uniform(1.2, 1.8, n)  # ior
    rec[:, 17] = 1.0  # opacity
    eta = np.where(rs.uniform(size=n) < 0.5, 1.0 / rec[:, 16], rec[:, 16])
    f32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32))
    return dict(
        rec=f32(rec), eta=f32(eta), vw=f32(vw), nw=f32(nw), dir=f32(unit(rs.standard_normal((n, 3)))),
        u=f32(rs.uniform(0.0, 1.0, (n, 3))), ct_a=f32(rs.standard_normal((n, 3))),
        ct_b=f32(rs.standard_normal((n, 3))),
    )


def _material(rec):
    """A finalized [N] material batch whose float fields are columns of rec."""
    cols = iter(range(20))
    fields = {}
    for name, arity in MAT_FIELDS:
        idx = [next(cols) for _ in range(arity)]
        if name == "alpha_mode":
            continue
        fields[name] = V3(*(rec[:, j] for j in idx)) if arity == 3 else rec[:, idx[0]]
    base = stack_materials([make_material()] * rec.shape[0])
    return finalize_material(base._replace(**fields))


@pytest.mark.parametrize("sample", [False, True], ids=["disney_eval", "disney_sample"])
def test_bsdf_adjoints_match_autograd(bwd_lib, sample):
    n = 512
    x = _lanes(n, 5 + sample)
    out = {k: torch.zeros(n * m) for k, m in (("rec", 20), ("eta", 1), ("vw", 3), ("nw", 3))}
    bwd_lib.host_bsdf_adj(
        int(sample), n, *(x[k].data_ptr() for k in ("rec", "eta", "vw", "nw", "dir", "u", "ct_a", "ct_b")),
        *(out[k].data_ptr() for k in ("rec", "eta", "vw", "nw")),
    )
    leaves = {k: x[k].clone().requires_grad_(True) for k in ("rec", "eta", "vw", "nw")}
    v3 = lambda a: V3(a[:, 0], a[:, 1], a[:, 2])
    mat = _material(leaves["rec"])
    if sample:
        u = x["u"]
        bs = bsdf.disney_sample(mat, leaves["eta"], v3(leaves["vw"]), v3(leaves["nw"]), v3(x["dir"]),
                                (u[:, 0], u[:, 1], u[:, 2]), detach=True)
        loss = sum((bs.l[c] * x["ct_a"][:, c]).sum() + (bs.f[c] * x["ct_b"][:, c]).sum() for c in range(3))
    else:
        f, pdf = bsdf.disney_eval(mat, leaves["eta"], v3(leaves["vw"]), v3(leaves["nw"]), v3(x["dir"]))
        loss = sum((f[c] * x["ct_a"][:, c]).sum() for c in range(3)) + (pdf * x["ct_b"][:, 0]).sum()
    grads = torch.autograd.grad(loss, list(leaves.values()))
    for name, ref in zip(leaves, grads):
        got = out[name].reshape(ref.shape).numpy().astype(np.float64)
        ref = ref.numpy().astype(np.float64)
        if name == "rec":
            ref = ref.copy()
            ref[:, [17, 18, 19]] = 0.0  # opacity and the alpha fields are only compared
        # lane by lane, relative to that lane's largest cotangent
        scale = np.abs(ref).reshape(n, -1).max(axis=1, keepdims=True) + 1e-6
        err = np.abs(got.reshape(n, -1) - ref.reshape(n, -1)) / scale
        assert np.isfinite(got).all(), name
        assert err.max() < 1e-3, (name, err.max())


def test_cpu_scene_with_grad_takes_the_plain_version():
    """On a CPU scene the wrapper's gradient is autograd of the plain
    version; K2 is not launched."""
    scene = make_scene(recursion_depth=2)
    em = scene.lights.emission.x
    em.requires_grad_(True)
    launches = MK.render_frame_megakernel.bwd_launches
    img = MK.render_frame_megakernel(scene, rng.prng_key(5), 16, 8)
    (g,) = torch.autograd.grad(img[..., :3].sum(), em)
    assert MK.render_frame_megakernel.bwd_launches == launches
    (ref,) = torch.autograd.grad(MK.render_frame_reference(scene, rng.prng_key(5), 16, 8)[..., :3].sum(), em)
    assert torch.equal(g, ref) and float(g.abs().sum()) > 0


def test_backward_takes_media_but_not_the_big_mesh():
    """K2 has a media instantiation on the analytical, SDF and mesh
    backends; the big mesh has no K2, with or without a medium."""
    for family in ("analytical", "sdf", "mesh"):
        MK._require_backward(family, media=True)
        assert MK.BACKENDS[family].media_backward.startswith("pt_render_backward_media")
    for media in (False, True):
        with pytest.raises(NotImplementedError, match="ROADMAP item 12"):
            MK._require_backward("bigmesh", media=media)


def test_backward_wrapper_refuses_cpu_tensors():
    k = MK.KernelLaunch(sv=torch.zeros(1, 112), keys=torch.zeros(1, 4, dtype=torch.int32),
                        out=torch.zeros(8, 8, 4), spp=1, depth=2, n_lights=1, n_materials=3, flags=0)
    with pytest.raises(ValueError, match="CUDA"):
        MK.launch_backward(k, torch.zeros(8, 8, 4))

