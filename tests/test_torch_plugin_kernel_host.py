"""The scene-backend plugins' kernel code (tests/torch_plugin_toy.cuh),
compiled for the host with the kernels' per-thread headers and held to the
plain version, as test_torch_kernel_host.py and
test_torch_kernel_bwd_host.py hold the built-in backends.

g++ builds the plugins' structs behind the host shim with `tracer.cuh`
and `tracer_adj.cuh`, over the view the plugin library's entry points
build (`tracer.cuh plugin_view`, lights found from the vector's length):

- K1's and K3's per-thread loop (`trace_sample`, the loop a plugin's
  instantiation runs) for the toy, with and without the medium: the
  compacted schedule's frames and counts (TILED, over a material table of
  one record, which the tracer's MatRef reads) bit for bit the per-thread
  loop's; the counts the plain version's (`tracer.bounces_entered`); the
  frame within the image gate of the plain version (quantile(|diff|,
  0.999) < 1e-4, mean < 1e-5); pixel ranges the whole frame's pixels bit
  for bit;
- `toy::ToyExtra`, its sphere read from the extra tensor through
  SceneView::extras, the toy's frame bit for bit; `toy::Stripes` against
  the eager stripes scene at the image gate;
- K2's record and adjoint steps for `toy::ToyAdj` (HOST_BACKWARD), with
  and without the medium, against autograd of the plain version
  (`render_grad_reference` over `toy_unpack`) at
  test_torch_kernel_bwd_host.py's tolerance, and the records' carries bit
  for bit those tracer.cuh's bounce hands on.

About 25 s, most of it the one g++ build.
"""

import ctypes

import numpy as np
import pytest
import torch

import torch_plugin_toy as toy
from pathtracer_tpu_torch.integrator import tracer as T
from pathtracer_tpu_torch.integrator.tracer import FIXED, VERBATIM
from pathtracer_tpu_torch.ops import megakernel as MK
from pathtracer_tpu_torch.ops import rng
from test_torch_kernel_bwd_host import HOST_BACKWARD, assert_carries_equal, assert_grad_close, record_carries
from test_torch_kernel_host import PRELUDE, TILED, build_shim, launch_keys
from test_torch_kernel_host import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# The plugins' frames on the host: `which` 0 toy::Toy, 1 toy::ToyExtra, 2
# toy::Stripes; the per-thread loop over the pixel range or, with `tiled`,
# the compacted schedule (its lists shuffled from `seed`); MEDIA with
# `media` (the toy); K3's counts into `entered`. K2 for toy::ToyAdj.
ENTRIES = r"""
template <class B, bool MEDIA>
static void plugin_frame(const pt::SceneView& s, const uint32_t* keys, float* out, int* entered, int width,
                         int height, int spp, int depth, int flags, int tiled, uint32_t seed, int p_begin,
                         int p_count) {
  if (tiled) {
    return tiled_frame<B, MEDIA>(s, keys, out, entered, width, height, spp, depth, flags, seed, p_begin, p_count);
  }
  const int n = width * height;
  for (int p = p_begin; p < p_begin + p_count; ++p) {
    pt::V3 sum = pt::splat3(0.0f);
    for (int k = 0; k < spp; ++k) {
      const uint32_t* kk = keys + 4 * k;
      pt::V3 r = pt::trace_sample<B, true, MEDIA>(s, p, n, width, height, depth, flags, kk[0], kk[1], kk[2], kk[3],
                                                  entered + k * n + p);
      sum = k == 0 ? r : sum + r;
    }
    if (spp > 1) sum = sum / (float)spp;
    out[4 * p + 0] = sum.x;
    out[4 * p + 1] = sum.y;
    out[4 * p + 2] = sum.z;
    out[4 * p + 3] = 1.0f;
  }
}

extern "C" void host_plugin_frame(int which, const float* sv, int n_sv, const uint32_t* keys, float* out,
                                  int* entered, int width, int height, int spp, int depth, int n_lights,
                                  int n_materials, int flags, const float* const* extras, int n_extras, int media,
                                  int tiled, uint32_t seed, int p_begin, int p_count) {
  const pt::SceneView s = pt::plugin_view(sv, n_sv, n_lights, n_materials, media != 0, flags, extras, n_extras);
  auto run = [&](auto backend) {
    using B = decltype(backend);
    (media ? plugin_frame<B, true> : plugin_frame<B, false>)(s, keys, out, entered, width, height, spp, depth, flags,
                                                              tiled, seed, p_begin, p_count);
  };
  if (which == 0) run(toy::Toy{});
  if (which == 1) run(toy::ToyExtra{});
  if (which == 2) run(toy::Stripes{});
}

extern "C" void host_toy_grad(const float* sv, int n_sv, const uint32_t* keys, const float* ct, float* grad,
                              int width, int height, int spp, int depth, int n_lights, int n_materials, int flags,
                              int media) {
  const pt::SceneView s = pt::plugin_view(sv, n_sv, n_lights, n_materials, media != 0, flags, nullptr, 0);
  (media ? host_backward<toy::ToyAdj, true> : host_backward<toy::ToyAdj, false>)(s, keys, ct, grad, width, height,
                                                                                 spp, depth, flags);
}

extern "C" void host_toy_carries(const float* sv, int n_sv, const uint32_t* keys, int width, int height, int spp,
                                 int depth, int n_lights, int n_materials, int flags, int media, float* rec_carry,
                                 float* ref_carry, int* rec_len, int* ref_len) {
  const pt::SceneView s = pt::plugin_view(sv, n_sv, n_lights, n_materials, media != 0, flags, nullptr, 0);
  (media ? host_carries<toy::ToyAdj, true> : host_carries<toy::ToyAdj, false>)(
      s, keys, width, height, spp, depth, flags, rec_carry, ref_carry, rec_len, ref_len);
}
"""


@pytest.fixture(scope="module")
def plugin_lib(tmp_path_factory):
    source = PRELUDE + f'#include "{toy.HEADER}"\n#include "tracer_adj.cuh"\n' + TILED + HOST_BACKWARD + ENTRIES
    lib = build_shim(tmp_path_factory.mktemp("plugin_host"), source)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.host_plugin_frame.argtypes = [i, p, i, p, p, p] + [i] * 7 + [p, i, i, i, ctypes.c_uint32, i, i]
    lib.host_toy_grad.argtypes = [p, i, p, p, p] + [i] * 8
    lib.host_toy_carries.argtypes = [p, i, p] + [i] * 8 + [p] * 4
    return lib


PLUGIN_INDEX = {"toy": 0, "toy_extra": 1, "stripes": 2}


def host_frame(lib, scene, key, w, h, spp, quirks, seed=None, pixels=None):
    """What the plugin's K3 launch computes from the same inputs, on the
    host: (the frame, the bounces each sample's path entered); with a
    `seed` through the compacted schedule; over the pixel range `pixels`,
    the others left NaN and -1."""
    k = MK.prepare_launch(scene, key, w, h, spp, quirks)  # the packed vector, extras table and counts on the CPU
    keys = launch_keys(key, spp)  # held: the library reads their memory
    out = torch.full((h, w, 4), float("nan"), dtype=torch.float32)
    entered = torch.full((spp, h, w), -1, dtype=torch.int32)
    lib.host_plugin_frame(
        PLUGIN_INDEX[k.backend], k.sv.data_ptr(), k.sv.shape[1], keys.data_ptr(), out.data_ptr(), entered.data_ptr(),
        w, h, spp, k.depth, k.n_lights, k.n_materials, k.flags, k.extras[0].data_ptr(), *k.counts, int(k.media),
        int(seed is not None), seed or 0, *(pixels or (0, w * h)),
    )
    return out, entered


def assert_image_gate(img, ref):
    diff = np.abs(img.numpy().astype(np.float64) - ref.numpy())
    assert np.isfinite(img.numpy()).all()
    assert np.quantile(diff, 0.999) < 1e-4, np.quantile(diff, 0.999)
    assert diff.mean() < 1e-5, diff.mean()


CASES = {
    "toy": (lambda: toy.make_toy_scene(recursion_depth=4), 1, VERBATIM),
    "toy_spp2_fixed": (lambda: toy.make_toy_scene(recursion_depth=4), 2, FIXED),
    "toy_media_scatter": (lambda: toy.make_toy_media_scene(recursion_depth=6), 1, VERBATIM),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_toy_kernel_code_matches_plain_version(plugin_lib, case):
    """toy::Toy through the per-thread loop against the plain version (the
    eager toy) at the image gate, its counts the plain version's; the
    compacted schedule over the one-record material table (MatRef) the
    per-thread loop's bit for bit; MEDIA on the glass toy."""
    make, spp, quirks = CASES[case]
    scene = make()
    assert MK.scene_media(scene) == ("media" in case)
    key = rng.prng_key(sorted(CASES).index(case) + 61)
    seed = int(np.random.default_rng(sorted(CASES).index(case)).integers(2**32))
    w, h = 99, 65
    img, entered = host_frame(plugin_lib, scene, key, w, h, spp, quirks)
    tiled, tiled_entered = host_frame(plugin_lib, scene, key, w, h, spp, quirks, seed)
    assert torch.equal(tiled, img) and torch.equal(tiled_entered, entered)
    assert torch.equal(entered, T.bounces_entered(scene, key, w, h, spp, quirks))
    assert int(entered.max()) >= (4 if "media" in case else 2)  # a path off the convex sphere meets only the sky
    assert_image_gate(img, MK.render_frame_reference(scene, key, w, h, spp, quirks))


def test_toy_kernel_code_over_pixel_ranges(plugin_lib):
    """The per-thread loop over pixel ranges: each the whole frame's pixels
    and counts bit for bit, nothing else written."""
    scene, key, w, h = toy.make_toy_scene(recursion_depth=4), rng.prng_key(67), 99, 65
    whole, whole_entered = host_frame(plugin_lib, scene, key, w, h, 1, VERBATIM)
    whole, whole_entered = whole.reshape(-1, 4), whole_entered.reshape(-1)
    for begin, count in ((0, 3264), (3264, 3171), (100, 777), (3001, 1)):
        img, entered = host_frame(plugin_lib, scene, key, w, h, 1, VERBATIM, pixels=(begin, count))
        img, entered = img.reshape(-1, 4), entered.reshape(-1)
        inside = torch.zeros(w * h, dtype=torch.bool)
        inside[begin:begin + count] = True
        assert torch.equal(img[inside], whole[inside]) and torch.equal(entered[inside], whole_entered[inside])
        assert img[~inside].isnan().all() and (entered[~inside] == -1).all()


@pytest.mark.parametrize("spp,quirks", [(1, VERBATIM), (2, FIXED)], ids=["spp1", "spp2_fixed"])
def test_extra_tensor_plugin_is_the_toy(plugin_lib, spp, quirks):
    """toy::ToyExtra reads the sphere from its extra tensor: the toy's frame
    and counts bit for bit."""
    key = rng.prng_key(71 + spp)
    want = host_frame(plugin_lib, toy.make_toy_scene(), key, 64, 48, spp, quirks)
    got = host_frame(plugin_lib, toy.make_toy_scene(extra=True), key, 64, 48, spp, quirks)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("spp,quirks,respect", [(1, VERBATIM, False), (2, FIXED, True)],
                         ids=["verbatim", "fixed_respect_max_dist"])
def test_stripes_kernel_code_matches_plain_version(plugin_lib, spp, quirks, respect):
    """toy::Stripes (the analytical backend with the hook after its closest
    hit) against the eager stripes scene at the image gate, its counts the
    plain version's; the hook moved the frame."""
    scene = toy.make_stripes_scene(respect_max_dist=respect)
    key = rng.prng_key(75 + spp)
    img, entered = host_frame(plugin_lib, scene, key, 96, 64, spp, quirks)
    assert_image_gate(img, MK.render_frame_reference(scene, key, 96, 64, spp, quirks))
    assert torch.equal(entered, T.bounces_entered(scene, key, 96, 64, spp, quirks))
    plain = MK.render_frame_reference(toy.make_stripes_scene().replace(closest_hit_fn=toy.analytical.closest_hit),
                                      key, 96, 64, spp, quirks)
    assert float((plain - img).abs().max()) > 1e-2


def host_toy_grad(lib, scene, key, ct, w, h, spp, quirks):
    """What K2 computes for the toy from the same inputs, on the host: (sv,
    d(sum(ct * frame))/d(sv))."""
    k = MK.prepare_launch(scene, key, w, h, spp, quirks)
    keys, ct = launch_keys(key, spp), ct.contiguous()
    grad = torch.zeros(k.sv.shape[1], dtype=torch.float32)
    lib.host_toy_grad(k.sv.data_ptr(), k.sv.shape[1], keys.data_ptr(), ct.data_ptr(), grad.data_ptr(), w, h, spp,
                      k.depth, k.n_lights, k.n_materials, k.flags, int(k.media))
    return k.sv, grad[None]


GRAD_CASES = {
    "toy_d3": (lambda: toy.make_toy_scene(recursion_depth=3), 1, VERBATIM),
    "toy_d4_spp2_fixed": (lambda: toy.make_toy_scene(recursion_depth=4), 2, FIXED),
    "toy_media_scatter": (lambda: toy.make_toy_media_scene(recursion_depth=6), 1, VERBATIM),
}


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_toy_backward_code_matches_autograd(plugin_lib, case):
    """toy::ToyAdj through K2's record and adjoint steps against autograd of
    the plain version over toy_unpack; every entry the toy's adjoint writes
    (center, radius, sky, material 0) and the light's get a gradient."""
    make, spp, quirks = GRAD_CASES[case]
    scene = make()
    w, h = 32, 16
    seed = sorted(GRAD_CASES).index(case) + 81
    key = rng.prng_key(seed)
    ct = torch.from_numpy(np.random.default_rng(seed).standard_normal((h, w, 4)).astype(np.float32))
    sv, grad = host_toy_grad(plugin_lib, scene, key, ct, w, h, spp, quirks)
    ref = MK.render_grad_reference(sv, scene, key, ct, w, h, spp, quirks)
    assert_grad_close(grad, ref)
    for i in (12, 15, 16, 19, 22, toy.TOY_LIGHTS_AT + 3, toy.TOY_LIGHTS_AT + 15):  # center, radius, sky, light, rgb
        assert float(grad[0, i].abs()) > 0, i


@pytest.mark.parametrize("media", [False, True], ids=["plain", "media"])
def test_toy_records_carry_what_bounce_hands_on(plugin_lib, media):
    """K2's record step writes, bounce by bounce, the carry tracer.cuh's
    bounce (media_bounce) hands on for the toy, bit for bit."""
    scene = toy.make_toy_media_scene() if media else toy.make_toy_scene(recursion_depth=4)
    w, h, spp = 32, 16, 1
    k = MK.prepare_launch(scene, rng.prng_key(91), w, h, spp, VERBATIM)
    keys = launch_keys(rng.prng_key(91), spp)
    head = (k.sv.data_ptr(), k.sv.shape[1], keys.data_ptr(), w, h, spp, k.depth, k.n_lights, k.n_materials, k.flags,
            int(media))
    assert_carries_equal(*record_carries(plugin_lib.host_toy_carries, head, w, h, spp, k.depth, 20 if media else 14))
