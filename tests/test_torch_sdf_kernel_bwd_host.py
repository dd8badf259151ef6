"""The SDF backend's adjoint (K5 inside K2, `csrc/sdf_adj.cuh`), compiled
for the host and held to torch autograd of its plain version.

As in tests/test_torch_kernel_bwd_host.py, g++ builds the per-thread
headers behind the shim's qualifiers (-ffp-contract=off, like the plain
version's separate tensor ops) and a host loop runs K2's record step and
then its adjoint step with `SdfAdj` for every pixel and sample as K2's two
kernels' threads do (HOST_BACKWARD); the records' carries are held bit for
bit to what tracer.cuh's bounce hands on, and the summed d(<ct, frame>)/d(sv) to
`ops/megakernel.render_grad_reference`, autograd of the eager frame of the
scene `megakernel_sdf.unpack_sdf_scene` reads from the same packed vector,
at that module's tolerances (entries above 1e-3 max|ref| within rtol 5e-3,
the others within 1e-3 max|ref|).

The pieces are held one by one against autograd of `models/sdf`, at
seeded random points and at crafted ties (box faces, edges and corners,
the torus ring and axis, equidistant primitives, a twin sphere whose every
point is a tie, the smooth union's clip edges): the field's first
derivatives (what the Newton step sends on), the normal's VJP (the
Hessian-vector product for the point and the mixed derivatives for the
record), the whole closest hit with the checker, and the sky. Lane by lane
the gradients agree to 1e-3 of the lane's largest entry (or of 1e-3 of the
largest over all lanes, for a lane whose terms cancel to zero).
"""

import ctypes

import numpy as np
import pytest
import torch

from pathtracer_tpu_torch.integrator.tracer import FIXED, VERBATIM
from pathtracer_tpu_torch.models import analytical, sdf
from pathtracer_tpu_torch.models.material import gather_material
from pathtracer_tpu_torch.ops import megakernel as MK
from pathtracer_tpu_torch.ops import megakernel_sdf as MS
from pathtracer_tpu_torch.ops import rng
from pathtracer_tpu_torch.ops.vecmath import V3
from test_torch_kernel_bwd_host import HOST_BACKWARD, assert_carries_equal, assert_grad_close, record_carries
from test_torch_kernel_host import PRELUDE, build_shim, launch_keys, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SHIM = PRELUDE + r"""
#include "sdf_adj.cuh"
#include "tracer_adj.cuh"
""" + HOST_BACKWARD + r"""

static pt::SceneView view(const float* sv, const int* counts, int n_lights, int n_materials) {
  return pt::sdf_view(sv, n_lights, n_materials, counts[0], counts[1], counts[2]);
}
static pt::V3 at3(const float* a, int i) { return pt::v3(a[3 * i], a[3 * i + 1], a[3 * i + 2]); }
static void put3(float* a, int i, pt::V3 v) { a[3 * i] = v.x; a[3 * i + 1] = v.y; a[3 * i + 2] = v.z; }

extern "C" void host_grad_sdf(const float* sv, const int* counts, const uint32_t* keys, const float* ct, float* grad,
                              int width, int height, int spp, int depth, int n_lights, int n_materials, int flags) {
  WITH_SDF_COUNTS(counts[0], counts[1], counts[2],
                  host_backward<pt::SdfAdj<C>, false>(view(sv, counts, n_lights, n_materials), keys, ct, grad, width,
                                                      height, spp, depth, flags));
}

extern "C" void host_carries_sdf(const float* sv, const int* counts, const uint32_t* keys, int width, int height,
                                 int spp, int depth, int n_lights, int n_materials, int flags, float* rec_carry,
                                 float* ref_carry, int* rec_len, int* ref_len) {
  WITH_SDF_COUNTS(counts[0], counts[1], counts[2],
                  host_carries<pt::SdfAdj<C>, false>(view(sv, counts, n_lights, n_materials), keys, width, height, spp,
                                                     depth, flags, rec_carry, ref_carry, rec_len, ref_len));
}

// Point i: the field's first derivatives (c_f = 1 along no direction):
// grad_x f into c_x[3i], d f / d sv into the row grad[n_sv i].
extern "C" void host_field_grad(const float* sv, const int* counts, int n_lights, int n_materials, int n_sv, int n,
                                const float* x, float* c_x, float* grad) {
  WITH_SDF_COUNTS(counts[0], counts[1], counts[2], {
    pt::Dual w[C::PRIMS], kd[C::PRIMS];
    for (int i = 0; i < n; ++i) {
      const pt::DV3 xd = pt::dv3(at3(x, i), pt::splat3(0.0f));
      put3(c_x, i, pt::value(pt::sdf_union_forward<C>(sv, xd, w, kd)));
      pt::sdf_union_reverse<C>(sv, xd, w, kd, 1.0f, {grad + (size_t)n_sv * i, 1});
    }
  });
}

// Point i: the VJP of normal = safe_normalize(grad_x f) for the cotangent
// ct[3i], into c_x[3i] (the point) and the row grad[n_sv i] (the record).
extern "C" void host_normal_vjp(const float* sv, const int* counts, int n_lights, int n_materials, int n_sv, int n,
                                const float* x, const float* ct, float* c_x, float* grad) {
  WITH_SDF_COUNTS(counts[0], counts[1], counts[2], {
    pt::Dual w[C::PRIMS], kd[C::PRIMS];
    for (int i = 0; i < n; ++i) {
      const pt::V3 xi = at3(x, i);
      const pt::DV3 xd = pt::dv3(xi, pt::safe_normalize_adj(pt::sdf_gradient<C>(sv, xi), at3(ct, i)));
      put3(c_x, i, pt::tangent(pt::sdf_union_forward<C>(sv, xd, w, kd)));
      pt::sdf_union_reverse<C>(sv, xd, w, kd, 0.0f, {grad + (size_t)n_sv * i, 1});
    }
  });
}

// Ray i: the record step's march and winner; on a hit, the closest hit's
// adjoint for the cotangents of t, the normal and the material's rgb: c_ro,
// c_rd and the row grad[n_sv i]. hit[i] says whether the ray hit.
extern "C" void host_closest_hit_adj(const float* sv, const int* counts, int n_lights, int n_materials, int n_sv,
                                     int n, const float* ro, const float* rd, const float* ct_t, const float* ct_n,
                                     const float* ct_rgb, float* c_ro, float* c_rd, float* grad, uint8_t* hit) {
  const pt::SceneView s = view(sv, counts, n_lights, n_materials);
  WITH_SDF_COUNTS(counts[0], counts[1], counts[2], {
    for (int i = 0; i < n; ++i) {
      const pt::V3 o = at3(ro, i), d = at3(rd, i);
      int win;
      const float t = pt::SdfAdj<C>::closest_hit_rec(s, o, d, win);
      hit[i] = std::isfinite(t);
      pt::V3 co = pt::splat3(0.0f), cd = pt::splat3(0.0f);
      if (hit[i]) {
        pt::MatAdj a = pt::zero_mat_adj();
        a.rgb = at3(ct_rgb, i);
        pt::SdfAdj<C>::closest_hit_adj(s, o, d, t, win, ct_t[i], at3(ct_n, i), a, {grad + (size_t)n_sv * i, 1}, co,
                                       cd);
      }
      put3(c_ro, i, co);
      put3(c_rd, i, cd);
    }
  });
}

// Direction i: the sky's adjoint for the cotangent ct[3i]: c_rd and the row.
extern "C" void host_sky_adj(const float* sv, const int* counts, int n_lights, int n_materials, int n_sv, int n,
                             const float* rd, const float* ct, float* c_rd, float* grad) {
  const pt::SceneView s = view(sv, counts, n_lights, n_materials);
  WITH_SDF_COUNTS(counts[0], counts[1], counts[2], {
    for (int i = 0; i < n; ++i) {
      pt::V3 cd = pt::splat3(0.0f);
      pt::SdfAdj<C>::background_adj(s, at3(rd, i), at3(ct, i), {grad + (size_t)n_sv * i, 1}, cd);
      put3(c_rd, i, cd);
    }
  });
}
"""


def f32(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


class HostSdfAdj:
    """The shim's entry points, fed what K2's wrapper hands the kernel."""

    def __init__(self, lib):
        self.lib = lib

    @staticmethod
    def _scene(scene, w=8, h=8):
        # Held in variables until the call returns: ctypes gets raw pointers.
        sv = MS.pack_sdf_scene(scene, w, h).contiguous()
        counts = torch.tensor(MS.sdf_counts(scene), dtype=torch.int32)
        return sv, counts, scene.num_lights, int(scene.params.materials.roughness.shape[0])

    def grad(self, scene, key, ct, w, h, spp, quirks):
        sv, counts, n_lights, n_mat = self._scene(scene, w, h)
        keys, ct = launch_keys(key, spp), ct.contiguous()
        grad = torch.zeros(sv.shape[1], dtype=torch.float32)
        self.lib.host_grad_sdf(sv.data_ptr(), counts.data_ptr(), keys.data_ptr(), ct.data_ptr(), grad.data_ptr(),
                               w, h, spp, scene.recursion_depth, n_lights, n_mat, MK.kernel_flags(scene, quirks))
        return sv, grad[None]

    def carries(self, scene, key, w, h, spp, quirks):
        """record_carries of the shim's host_carries_sdf."""
        sv, counts, n_lights, n_mat = self._scene(scene, w, h)
        keys = launch_keys(key, spp)
        head = (sv.data_ptr(), counts.data_ptr(), keys.data_ptr(), w, h, spp, scene.recursion_depth, n_lights, n_mat,
                MK.kernel_flags(scene, quirks))
        return record_carries(self.lib.host_carries_sdf, head, w, h, spp, scene.recursion_depth, 14)

    def per_point(self, entry, scene, *arrays):
        """entry(sv, counts, n_lights, n_materials, n_sv, n, *arrays, out,
        grad rows) -> (out [n, 3], rows [n, n_sv])."""
        sv, counts, n_lights, n_mat = self._scene(scene)
        arrays = [f32(a) for a in arrays]
        n = arrays[0].shape[0]
        out = torch.zeros((n, 3), dtype=torch.float32)
        rows = torch.zeros((n, sv.shape[1]), dtype=torch.float32)
        getattr(self.lib, entry)(sv.data_ptr(), counts.data_ptr(), n_lights, n_mat, sv.shape[1], n,
                                 *(a.data_ptr() for a in arrays), out.data_ptr(), rows.data_ptr())
        return out, rows

    def closest_hit_adj(self, scene, ro, rd, ct_t, ct_n, ct_rgb):
        sv, counts, n_lights, n_mat = self._scene(scene)
        ro, rd, ct_t, ct_n, ct_rgb = (f32(a) for a in (ro, rd, ct_t, ct_n, ct_rgb))
        n = ro.shape[0]
        c_ro, c_rd = torch.zeros((n, 3)), torch.zeros((n, 3))
        rows = torch.zeros((n, sv.shape[1]))
        hit = torch.zeros(n, dtype=torch.uint8)
        self.lib.host_closest_hit_adj(sv.data_ptr(), counts.data_ptr(), n_lights, n_mat, sv.shape[1], n,
                                      ro.data_ptr(), rd.data_ptr(), ct_t.data_ptr(), ct_n.data_ptr(),
                                      ct_rgb.data_ptr(), c_ro.data_ptr(), c_rd.data_ptr(), rows.data_ptr(),
                                      hit.data_ptr())
        return sv, c_ro, c_rd, rows, hit.bool()


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    lib = build_shim(tmp_path_factory.mktemp("sdf_kernel_bwd_host"), SHIM)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.host_grad_sdf.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i]
    lib.host_carries_sdf.argtypes = [p, p, p, i, i, i, i, i, i, i, p, p, p, p]
    lib.host_field_grad.argtypes = [p, p, i, i, i, i, p, p, p]
    lib.host_normal_vjp.argtypes = [p, p, i, i, i, i, p, p, p, p]
    lib.host_closest_hit_adj.argtypes = [p, p, i, i, i, i] + [p] * 9
    lib.host_sky_adj.argtypes = [p, p, i, i, i, i, p, p, p, p]
    return HostSdfAdj(lib)


def sdf_scene(smooth_k: float = 0.0, recursion_depth: int = 4, twin: bool = False):
    """The demo scene, with a smooth union of width smooth_k, or with a
    second sphere equal to the first (every point of it a tie)."""
    scene = sdf.make_scene(recursion_depth=recursion_depth)
    if twin:
        p = scene.params.unpack()
        two = lambda a: torch.cat([a, a])
        p = p._replace(sphere_center=V3(*(two(c) for c in p.sphere_center)), sphere_radius=two(p.sphere_radius),
                       materials=gather_material(p.materials, torch.tensor([0, 0, 1, 2, 3])))
        scene = scene.replace(params=p)
    scene.params.smooth_k = torch.tensor(smooth_k)
    return scene


def _leaf_sv(scene, w=8, h=8):
    sv = MS.pack_sdf_scene(scene, w, h).detach().clone().requires_grad_(True)
    params = MS.unpack_sdf_scene(sv, scene)[0].params.unpack()
    return sv, params


def _points() -> np.ndarray:
    """[N, 3] points: random ones around the scene, points near each
    surface, then crafted ties (box faces, edges, corners and center, the
    torus ring, axis and center, the sphere touching the plane, the plane;
    not the sphere's center, where its gradient q/|q| is 0/0 on both
    sides)."""
    rs = np.random.default_rng(11)
    pts = [rs.uniform([-3, -1.5, -2], [3, 2.5, 3], (300, 3))]
    u = rs.normal(size=(100, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    pts.append(np.array([-1.3, 0.0, 0.0]) + u * rs.uniform(0.99, 1.01, (100, 1)))
    pts.append(np.array([1.3, -0.25, 0.0]) + rs.uniform(-0.8, 0.8, (100, 3)))
    pts.append(np.array([0.0, -0.7, 1.2]) + rs.uniform([-0.65, -0.2, -0.65], [0.65, 0.2, 0.65], (100, 3)))
    box_c, half = np.array([1.3, -0.25, 0.0]), 0.7
    faces = [(half, 0, 0), (-half, 0.2, 0.1), (half, half, 0), (half, half, half), (-half, half, -half),
             (half + 0.1, half + 0.1, 0), (0.3, 0.3, 0.1), (0.2, 0.2, 0.2), (0, 0, 0), (0, 0.5, 0), (0.9, 0, 0)]
    pts.append(box_c + np.array(faces))
    tor_c, major = np.array([0.0, -0.7, 1.2]), 0.45
    pts.append(tor_c + np.array([(major, 0, 0), (0, 0, major), (0, 0, 0), (0, 0.3, 0), (major, 0.1, 0)]))
    pts.append(np.array([(-1.3, -1.0, 0.0), (0.5, -1.0, -2.0)]))
    return np.concatenate(pts).astype(np.float32)


def _ref_rows(out_fn, sv, params, x, ct=None):
    """Per-point autograd of out_fn(params, x) (a scalar field, or a V3
    contracted with ct): [n, 3] for x and [n, n_sv] for sv (each point's
    output depends on its own x only; sv's rows are one batched backward)."""
    n = x.shape[0]
    xs = torch.from_numpy(x).requires_grad_(True)
    out = out_fn(params, V3(xs[:, 0], xs[:, 1], xs[:, 2]))
    if ct is not None:
        ct = torch.from_numpy(np.asarray(ct, np.float32))
        out = sum(out[c] * ct[:, c] for c in range(3))
    (c_x,) = torch.autograd.grad(out.sum(), xs, retain_graph=True)
    (rows,) = torch.autograd.grad(out, sv, grad_outputs=torch.eye(n), is_grads_batched=True)
    return c_x.numpy(), rows[:, 0].numpy()


def assert_lanes_close(got, ref, name, tol=1e-3):
    """Lane by lane, within tol of that lane's largest entry, or of tol
    times the largest entry of all lanes where that is more (a lane whose
    terms cancel to zero keeps its rounding)."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert np.isfinite(got).all(), name
    scale = np.maximum(np.abs(ref).max(axis=1, keepdims=True), tol * np.abs(ref).max())
    err = np.abs(got - ref) / scale
    assert err.max() < tol, (name, float(err.max()), int(err.max(axis=1).argmax()))


FIELD_SCENES = {
    "demo": lambda: sdf_scene(),
    "smooth": lambda: sdf_scene(0.3),
    "twin": lambda: sdf_scene(twin=True),
}


@pytest.mark.parametrize("variant", sorted(FIELD_SCENES))
def test_field_first_derivatives_match_autograd(host, variant):
    """What the Newton step sends on: grad_x f and d f / d sv."""
    scene = FIELD_SCENES[variant]()
    x = _points()
    c_x, rows = host.per_point("host_field_grad", scene, x)
    sv, params = _leaf_sv(scene)
    ref_x, ref_rows = _ref_rows(sdf.scene_sdf, sv, params, x)
    assert_lanes_close(c_x.numpy(), ref_x, "x")
    assert_lanes_close(rows.numpy(), ref_rows, "sv")


@pytest.mark.parametrize("variant", sorted(FIELD_SCENES))
def test_normal_vjp_matches_autograd(host, variant):
    """The normal's VJP: H c for the point, the mixed derivatives for the
    record, through the union with its shares, at random points and ties."""
    scene = FIELD_SCENES[variant]()
    x = _points()
    ct = np.random.default_rng(3).standard_normal(x.shape).astype(np.float32)
    c_x, rows = host.per_point("host_normal_vjp", scene, x, ct)
    sv, params = _leaf_sv(scene)
    ref_x, ref_rows = _ref_rows(sdf.sdf_normal, sv, params, x, ct)
    assert_lanes_close(c_x.numpy(), ref_x, "x")
    assert_lanes_close(rows.numpy(), ref_rows, "sv")


def test_smooth_union_clip_edges(host):
    """Points where the smooth union's blend h sits exactly at 0 or 1 (the
    two distances differ by exactly k), and inside the blend: jax.grad's
    0.5 share at the clip edge, 0 derivative of the share."""
    scene = sdf_scene(0.25)
    # on the x axis between the sphere (surface at x = -0.3) and the box
    # (face at x = 0.6); the plane is far below (y = 0 is 1 above it)
    xs = np.array([0.15 - 0.125, 0.15 + 0.125, 0.15, 0.1, 0.2], np.float32)
    x = np.stack([xs, np.zeros_like(xs), np.zeros_like(xs)], 1)
    ct = np.tile(np.array([[0.3, -0.8, 0.5]], np.float32), (len(xs), 1))
    c_x, rows = host.per_point("host_normal_vjp", scene, x, ct)
    sv, params = _leaf_sv(scene)
    ref_x, ref_rows = _ref_rows(sdf.sdf_normal, sv, params, x, ct)
    assert_lanes_close(c_x.numpy(), ref_x, "x")
    assert_lanes_close(rows.numpy(), ref_rows, "sv")
    g, rows = host.per_point("host_field_grad", scene, x)
    ref_x, ref_rows = _ref_rows(sdf.scene_sdf, sv, params, x)
    assert_lanes_close(g.numpy(), ref_x, "x")
    assert_lanes_close(rows.numpy(), ref_rows, "sv")


def _camera_rays(n: int, seed: int):
    """Rays from around the camera toward the scene, and rays skimming the
    sphere and the plane (grazing hits)."""
    rs = np.random.default_rng(seed)
    ro = np.tile([[0.0, 0.0, 3.0]], (n, 1)) + rs.uniform(-0.2, 0.2, (n, 3))
    rd = rs.uniform([-0.8, -0.6, -1.0], [0.8, 0.5, -1.0], (n, 3))
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return ro.astype(np.float32), rd.astype(np.float32)


@pytest.mark.parametrize("smooth_k", [0.0, 0.3], ids=["hard", "smooth"])
def test_closest_hit_adjoint_matches_autograd(host, smooth_k):
    """Newton reattachment, normal VJP, material and checker pick of one
    closest hit, per ray, against autograd of models/sdf.closest_hit for
    the cotangents of t, the normal and the material's rgb."""
    scene = sdf_scene(smooth_k)
    ro, rd = _camera_rays(400, 7 + int(smooth_k * 10))
    rs = np.random.default_rng(8)
    ct_t, ct_n, ct_rgb = rs.standard_normal(len(ro)), rs.standard_normal(ro.shape), rs.standard_normal(ro.shape)
    _, c_ro, c_rd, rows, hit = host.closest_hit_adj(scene, ro, rd, ct_t, ct_n, ct_rgb)
    sv, params = _leaf_sv(scene)
    tro, trd = (torch.from_numpy(a).requires_grad_(True) for a in (ro, rd))
    h = sdf.closest_hit(params, V3(*tro.T), V3(*trd.T))
    assert torch.equal(torch.isfinite(h.t), hit)
    assert 0.3 < float(hit.double().mean()) < 0.95
    mask = hit.numpy()
    t = torch.where(hit, h.t, 0.0)
    out = t * f32(ct_t) + sum(h.normal[c] * f32(ct_n[:, c]) + h.material.rgb[c] * f32(ct_rgb[:, c]) for c in range(3))
    eye = torch.eye(len(ro))[mask]
    g_ro, g_rd, g_sv = torch.autograd.grad(out, [tro, trd, sv], grad_outputs=eye, is_grads_batched=True)
    rows_of = lambda g: g[np.arange(len(eye)), np.flatnonzero(mask)].numpy()
    ref = np.concatenate([rows_of(g_ro), rows_of(g_rd), g_sv[:, 0].numpy()], 1)
    lanes = np.concatenate([c_ro.numpy(), c_rd.numpy(), rows.numpy()], 1)[mask]
    assert_lanes_close(lanes, ref, "closest hit")
    # the plane's checker albedo entries carry the summed rgb cotangent
    albedo_at = 12 + 4 + 7 + 5 + 8
    assert np.abs(rows.numpy()[:, albedo_at:albedo_at + 2]).max() > 0


def test_sky_adjoint_matches_autograd(host):
    scene = sdf_scene()
    rs = np.random.default_rng(9)
    rd = rs.normal(size=(64, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    ct = rs.standard_normal(rd.shape).astype(np.float32)
    c_rd, rows = host.per_point("host_sky_adj", scene, rd, ct)
    sv, params = _leaf_sv(scene)
    ref_rd, ref_rows = _ref_rows(analytical.background, sv, params, rd, ct)
    assert_lanes_close(c_rd.numpy(), ref_rd, "rd")
    assert_lanes_close(rows.numpy(), ref_rows, "sv")


CASES = {
    "d2_spp1_verbatim": (2, 1, VERBATIM, 0.0),
    "d3_spp1_fixed": (3, 1, FIXED, 0.0),
    "d2_spp2_verbatim": (2, 2, VERBATIM, 0.0),
    "d2_spp2_fixed": (2, 2, FIXED, 0.0),
    "d3_spp1_smooth": (3, 1, VERBATIM, 0.3),
    "d2_spp2_smooth_fixed": (2, 2, FIXED, 0.3),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_sdf_backward_code_matches_autograd(host, case):
    depth, spp, quirks, smooth_k = CASES[case]
    scene = sdf_scene(smooth_k, depth)
    w, h = 24, 16
    seed = sorted(CASES).index(case) + 51
    key = rng.prng_key(seed)
    ct = torch.from_numpy(np.random.default_rng(seed).standard_normal((h, w, 4)).astype(np.float32))
    sv, grad = host.grad(scene, key, ct, w, h, spp, quirks)
    ref = MK.render_grad_reference(sv, scene, key, ct, w, h, spp, quirks)
    assert_grad_close(grad, ref)


@pytest.mark.parametrize("case", ["d2_spp2_fixed", "d3_spp1_smooth"])
def test_sdf_records_carry_what_bounce_hands_on(host, case):
    """K2's record step with SdfAdj (the march, the winner, the shadow
    march) writes the carry tracer.cuh's bounce with Sdf hands on."""
    depth, spp, quirks, smooth_k = CASES[case]
    assert_carries_equal(*host.carries(sdf_scene(smooth_k, depth), rng.prng_key(sorted(CASES).index(case) + 51), 24,
                                       16, spp, quirks))


def test_sdf_backward_and_records_twin_sphere(host):
    """The backend built for the counts (2, 1, 1), the twin sphere a tie at
    every point: K2's gradient against autograd, and its records' carries
    bit for bit what tracer.cuh's bounce hands on."""
    scene = sdf_scene(0.0, 2, twin=True)
    assert MS.sdf_counts(scene) == (2, 1, 1)
    w, h, key = 24, 16, rng.prng_key(61)
    ct = torch.from_numpy(np.random.default_rng(61).standard_normal((h, w, 4)).astype(np.float32))
    sv, grad = host.grad(scene, key, ct, w, h, 1, VERBATIM)
    assert_grad_close(grad, MK.render_grad_reference(sv, scene, key, ct, w, h, 1, VERBATIM))
    assert_carries_equal(*host.carries(sdf_scene(0.0, 3, twin=True), key, w, h, 2, FIXED))
