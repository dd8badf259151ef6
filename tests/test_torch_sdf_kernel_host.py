"""The SDF backend of the CUDA megakernel (K5, `csrc/sdf.cuh`) and the
march-step counter K6, compiled for the host and held to their plain
PyTorch versions.

As in tests/test_torch_kernel_host.py, g++ builds the per-thread headers
behind the shim's qualifiers, with -ffp-contract=off like the plain
version's separate tensor ops, and a host loop runs `trace_sample<Sdf>`,
the shadow march and K6's per-pixel count exactly as the kernels' threads
do. The march rounds as the plain version does (mul_rn, madd3), so the
frames agree within the image gate, and the trip counts pixel for pixel.
"""

import ctypes

import numpy as np
import pytest
import torch

from pathtracer_tpu_torch.integrator.tracer import FIXED, VERBATIM
from pathtracer_tpu_torch.models import sdf
from pathtracer_tpu_torch.ops import megakernel as MK
from pathtracer_tpu_torch.ops import megakernel_sdf as MS
from pathtracer_tpu_torch.ops import rng
from pathtracer_tpu_torch.ops.vecmath import V3
from test_torch_kernel_host import PRELUDE, build_shim, launch_keys, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SHIM = PRELUDE + r"""
#include "sdf.cuh"

static pt::SceneView view(const float* sv, const int* counts, int n_lights, int n_materials) {
  return pt::sdf_view(sv, n_lights, n_materials, counts[0], counts[1], counts[2]);
}

extern "C" void host_render_sdf(const float* sv, const int* counts, const uint32_t* keys, float* out, int width,
                                int height, int spp, int depth, int n_lights, int n_materials, int flags) {
  const int n = width * height;
  const pt::SceneView s = view(sv, counts, n_lights, n_materials);
  for (int p = 0; p < n; ++p) {
    pt::V3 sum = pt::splat3(0.0f);
    for (int k = 0; k < spp; ++k) {
      const uint32_t* kk = keys + 4 * k;
      pt::V3 r = pt::trace_sample<pt::Sdf>(s, p, n, width, height, depth, flags, kk[0], kk[1], kk[2], kk[3]);
      sum = k == 0 ? r : sum + r;
    }
    if (spp > 1) sum = sum / (float)spp;
    out[4 * p + 0] = sum.x;
    out[4 * p + 1] = sum.y;
    out[4 * p + 2] = sum.z;
    out[4 * p + 3] = 1.0f;
  }
}

extern "C" void host_march_steps(const float* sv, const int* counts, int n_lights, int n_materials, int width,
                                 int height, int* steps, int* shadow_steps) {
  const pt::SceneView s = view(sv, counts, n_lights, n_materials);
  for (int p = 0; p < width * height; ++p) pt::march_steps_pixel(s, p, width, height, steps[p], shadow_steps[p]);
}

// Shadow ray i from ro[3i] along rd[3i]: the kernel's capped decision and
// the uncapped march's (t < max_dist after the full march).
extern "C" void host_shadow(const float* sv, const int* counts, int n_lights, int n_materials, int n, const float* ro,
                            const float* rd, const float* max_dist, uint8_t* capped, uint8_t* uncapped) {
  const pt::SceneView s = view(sv, counts, n_lights, n_materials);
  for (int i = 0; i < n; ++i) {
    const pt::V3 o = pt::v3(ro[3 * i], ro[3 * i + 1], ro[3 * i + 2]);
    const pt::V3 d = pt::v3(rd[3 * i], rd[3 * i + 1], rd[3 * i + 2]);
    capped[i] = pt::sdf_any_hit(s, o, d, max_dist[i]);
    const float t = pt::sdf_march(s, o, d, pt::SDF_T_MAX).t;
    uncapped[i] = pt::sdf_converged(s, o, d, t) && t < max_dist[i];
  }
}
"""


class HostSdf:
    """The shim's entry points, fed what the wrappers hand the kernels."""

    def __init__(self, lib):
        self.lib = lib

    def _scene(self, scene, w, h):
        # Held in variables until the call returns: ctypes gets raw pointers.
        sv = MS.pack_sdf_scene(scene, w, h).contiguous()
        counts = torch.tensor(MS.sdf_counts(scene), dtype=torch.int32)
        return sv, counts, scene.num_lights, int(scene.params.materials.roughness.shape[0])

    def render(self, scene, key, w, h, spp, quirks):
        sv, counts, n_lights, n_mat = self._scene(scene, w, h)
        keys = launch_keys(key, spp)
        out = torch.empty((h, w, 4), dtype=torch.float32)
        self.lib.host_render_sdf(sv.data_ptr(), counts.data_ptr(), keys.data_ptr(), out.data_ptr(), w, h, spp,
                                 scene.recursion_depth, n_lights, n_mat, MK.kernel_flags(scene, quirks))
        return out

    def march_steps(self, scene, w, h):
        sv, counts, n_lights, n_mat = self._scene(scene, w, h)
        steps = torch.empty((h, w), dtype=torch.int32)
        shadow = torch.empty((h, w), dtype=torch.int32)
        self.lib.host_march_steps(sv.data_ptr(), counts.data_ptr(), n_lights, n_mat, w, h, steps.data_ptr(),
                                  shadow.data_ptr())
        return steps, shadow

    def shadow(self, scene, ro, rd, max_dist):
        sv, counts, n_lights, n_mat = self._scene(scene, 8, 8)
        ro, rd = (torch.from_numpy(np.ascontiguousarray(a, np.float32)) for a in (ro, rd))
        max_dist = torch.from_numpy(np.ascontiguousarray(max_dist, np.float32))
        n = max_dist.numel()
        capped, uncapped = torch.empty(n, dtype=torch.uint8), torch.empty(n, dtype=torch.uint8)
        self.lib.host_shadow(sv.data_ptr(), counts.data_ptr(), n_lights, n_mat, n, ro.data_ptr(), rd.data_ptr(),
                             max_dist.data_ptr(), capped.data_ptr(), uncapped.data_ptr())
        return capped.numpy().astype(bool), uncapped.numpy().astype(bool)


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    lib = build_shim(tmp_path_factory.mktemp("sdf_kernel_host"), SHIM)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.host_render_sdf.argtypes = [p, p, p, p, i, i, i, i, i, i, i]
    lib.host_march_steps.argtypes = [p, p, i, i, i, i, p, p]
    lib.host_shadow.argtypes = [p, p, i, i, i, p, p, p, p, p]
    return HostSdf(lib)


def assert_image_close(img, ref):
    """quantile(|diff|, 0.999) < 1e-4, mean < 1e-5, all finite."""
    img, ref = np.asarray(img, np.float64), np.asarray(ref, np.float64)
    assert np.isfinite(img).all()
    diff = np.abs(img - ref)
    assert np.quantile(diff, 0.999) < 1e-4, np.quantile(diff, 0.999)
    assert diff.mean() < 1e-5, diff.mean()


def smooth_scene(smooth_k: float, recursion_depth: int = 4):
    """The demo scene with a smooth union of width smooth_k in place of
    its hard min (k = 0): the kernel's k > 0 branches."""
    scene = sdf.make_scene(recursion_depth=recursion_depth)
    scene.params.smooth_k = torch.tensor(smooth_k)
    return scene


@pytest.mark.parametrize(
    "depth,spp,quirks,seed,smooth_k",
    [(2, 1, VERBATIM, 31, 0.0), (4, 1, VERBATIM, 32, 0.0), (4, 1, FIXED, 33, 0.0), (2, 2, VERBATIM, 34, 0.0),
     (2, 2, FIXED, 35, 0.0), (4, 1, VERBATIM, 36, 0.3)],
    ids=["d2", "d4", "d4_fixed", "d2_spp2", "d2_spp2_fixed", "d4_smooth"],
)
def test_sdf_kernel_code_matches_plain_version(host, depth, spp, quirks, seed, smooth_k):
    scene = smooth_scene(smooth_k, depth)
    key = rng.prng_key(seed)
    img = host.render(scene, key, 32, 16, spp, quirks).numpy()
    ref = MK.render_frame_reference(scene, key, 32, 16, spp, quirks).numpy()
    assert_image_close(img, ref)
    assert img[..., :3].max() > 0.05


def assert_counts_match(host, scene):
    steps, shadow = host.march_steps(scene, 64, 48)
    ref_steps, ref_shadow = MS.march_steps_reference(scene, 64, 48)
    for got, ref in ((steps, ref_steps), (shadow, ref_shadow)):
        assert (got == ref).double().mean() >= 0.999
        assert int(got.min()) >= 1 and int(got.max()) <= sdf.MAX_STEPS
    return steps


def test_march_counts_match_plain_version(host):
    steps = assert_counts_match(host, sdf.make_scene())
    assert int(steps.max()) == sdf.MAX_STEPS  # grazing rays that never converge


def test_march_counts_match_plain_version_smooth_union(host):
    scene = smooth_scene(0.3)
    steps = assert_counts_match(host, scene)
    # the blend moves the field, so the march differs from the hard min's
    assert not torch.equal(steps, host.march_steps(sdf.make_scene(), 64, 48)[0])


def _shadow_rays(n: int, seed: int):
    """Random rays from around the scene toward random points, and grazing
    rays that skim the plane, the sphere and the box at a few ulps to a
    few HIT_EPS above their surfaces; max_dist from just short of the
    surface to past it."""
    rs = np.random.default_rng(seed)
    ro = rs.uniform([-4, -0.99, -3], [4, 4, 4], (n, 3))
    target = rs.uniform([-3, -1.5, -2], [3, 2, 2], (n, 3))
    k = n // 2
    # grazing: start above the plane y = -1 and run almost parallel to it
    ro[:k, 1] = -1.0 + rs.uniform(1e-4, 5e-3, k)
    target[:k] = ro[:k] + np.stack([rs.uniform(-1, 1, k), rs.uniform(-2e-3, 2e-3, k), rs.uniform(-1, 1, k)], 1)
    # tangents to the sphere (center (-1.3, 0, 0), r 1) from outside
    m = k // 2
    u = rs.normal(size=(m, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    tangent = np.cross(u, rs.normal(size=(m, 3)))
    tangent /= np.linalg.norm(tangent, axis=1, keepdims=True)
    touch = np.array([-1.3, 0.0, 0.0]) + u * (1.0 + rs.uniform(0, 3e-3, (m, 1)))
    ro[k:k + m] = touch - tangent * rs.uniform(0.5, 3, (m, 1))
    target[k:k + m] = touch + tangent
    rd = target - ro
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    max_dist = rs.uniform(0.0, 12.0, n)
    return ro, rd, max_dist


def test_capped_shadow_march_decides_as_uncapped(host):
    scene = sdf.make_scene()
    ro, rd, max_dist = _shadow_rays(100_000, 5)
    capped, uncapped = host.shadow(scene, ro, rd, max_dist)
    assert np.array_equal(capped, uncapped)
    assert 0.1 < uncapped.mean() < 0.9
    # and the plain version's any_hit (the uncapped march in torch) agrees
    idx = np.arange(0, 100_000, 10)
    f = lambda a: torch.from_numpy(a[idx].astype(np.float32))
    plain = sdf.any_hit(scene.params.unpack(), V3(*f(ro).T), V3(*f(rd).T), f(max_dist)).numpy()
    assert (plain == uncapped[idx]).mean() >= 0.999
