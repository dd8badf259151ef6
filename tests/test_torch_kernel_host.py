"""The CUDA megakernel's per-thread code, compiled for the host and held
to its plain PyTorch version.

`csrc/tracer.cuh` and the headers it includes are plain C++ apart from the
`__device__`/`__forceinline__` qualifiers and three intrinsics, so g++ builds
them behind the small shim below, and a host loop runs `trace_sample` with
the analytical backend for every pixel exactly as the kernel's threads do
(tests/test_torch_sdf_kernel_host.py does the same with the SDF backend). This checks the kernel's
path logic (lobes, lights, quirks, alpha, the threefry counters) where no
card is present; the card run (chip_smoke.py, test_torch_kernel_cuda.py)
checks what nvcc makes of it. The shim is built with -ffp-contract=off,
like the plain version's separate ops, so only libm ulps differ.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from pathtracer_tpu_torch.integrator.tracer import FIXED, VERBATIM
from pathtracer_tpu_torch.models import light as L
from pathtracer_tpu_torch.models.analytical import default_params, make_scene
from pathtracer_tpu_torch.ops import _build, megakernel as MK
from pathtracer_tpu_torch.ops import rng

# The per-thread headers are plain C++ behind these definitions.
PRELUDE = r"""
#include <algorithm>
#include <cmath>
#include <cstdint>
#define __device__
#define __forceinline__ inline
using std::isfinite;
using std::max;
using std::min;
static inline uint32_t __funnelshift_l(uint32_t lo, uint32_t hi, int s) {
  s &= 31;
  return s ? (hi << s) | (lo >> (32 - s)) : hi;
}
static inline float __fmul_rn(float a, float b) { return a * b; }
static inline float __fadd_rn(float a, float b) { return a + b; }
"""

SHIM = PRELUDE + r"""
#include "analytical.cuh"
#include "tracer.cuh"

extern "C" void host_render(const float* sv, const uint32_t* keys, float* out, int width, int height, int spp,
                            int depth, int n_lights, int n_materials, int flags) {
  const int n = width * height;
  const pt::SceneView s = pt::analytical_view(sv, n_lights, n_materials, (flags & pt::FLAG_RESPECT_MAX_DIST) != 0);
  for (int p = 0; p < n; ++p) {
    pt::V3 sum = pt::splat3(0.0f);
    for (int k = 0; k < spp; ++k) {
      const uint32_t* kk = keys + 4 * k;
      pt::V3 r = pt::trace_sample<pt::Analytical>(s, p, n, width, height, depth, flags, kk[0], kk[1], kk[2], kk[3]);
      sum = k == 0 ? r : sum + r;
    }
    if (spp > 1) sum = sum / (float)spp;
    out[4 * p + 0] = sum.x;
    out[4 * p + 1] = sum.y;
    out[4 * p + 2] = sum.z;
    out[4 * p + 3] = 1.0f;
  }
}
"""


@pytest.fixture(scope="module")
def one_torch_thread():
    """One torch thread for the module that takes it: the eager SDF march
    is ~100 small tensor ops a step, where torch's thread pool costs more
    than it gains (twice the time alone, far more beside other test
    processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


pytestmark = pytest.mark.usefixtures("one_torch_thread")


def build_shim(directory, source: str) -> ctypes.CDLL:
    """g++ builds `source` (PRELUDE plus headers of csrc/) into a library;
    skips without a host C++ compiler."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler to build the kernel's per-thread code")
    (directory / "shim.cpp").write_text(source)
    so = directory / "libshim.so"
    subprocess.run(
        [cxx, "-O2", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC",
         "-I", str(_build.CSRC), "-o", str(so), str(directory / "shim.cpp")],
        check=True, capture_output=True,
    )
    return ctypes.CDLL(str(so))


def launch_keys(key, spp: int) -> torch.Tensor:
    """The [spp, 4] sample keys as the kernels take them (uint32 in int32)."""
    keys = MK.sample_keys(key, spp)
    return torch.where(keys >= 2**31, keys - 2**32, keys).to(torch.int32).contiguous()


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    lib = build_shim(tmp_path_factory.mktemp("kernel_host"), SHIM)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.host_render.argtypes = [p, p, p, i, i, i, i, i, i, i]
    return lib


def host_render(lib, scene, key, w, h, spp, quirks):
    """What render_frame_megakernel hands the kernel, run on the host."""
    sv = MK.pack_scene(scene, w, h).contiguous()
    keys = launch_keys(key, spp)
    out = torch.empty((h, w, 4), dtype=torch.float32)
    lib.host_render(
        sv.data_ptr(), keys.data_ptr(), out.data_ptr(), w, h, spp,
        scene.recursion_depth, scene.num_lights, int(scene.params.materials.roughness.shape[0]),
        MK.kernel_flags(scene, quirks),
    )
    return out


def _three_lights():
    return L.concat_lights(
        L.spherical_light((3.0, 2.0, 2.0), 1.0, (3.0, 3.0, 3.0)),
        L.rect_light((-2.0, 3.0, -1.0), (1.0, 0.0, 0.0), (0.0, 0.0, 1.0), (2.0, 2.0, 2.0)),
        L.distant_light((0.3, 1.0, 0.2), (0.5, 0.5, 0.5)),
    )


def _alpha_glass_params():
    """Blend and Mask alpha, emission, and a half-metal transmissive sphere,
    where the stale prev_l Fresnel of disney_sample shows."""
    p = default_params()
    m = p.materials
    m = m._replace(
        alpha_mode=torch.tensor([0, 1, 2], dtype=torch.int32),
        opacity=torch.tensor([1.0, 0.4, 0.3]),
        alpha_cutoff=torch.tensor([0.0, 0.0, 0.5]),
        metallic=torch.tensor([0.5, 0.0, 0.0]),
        spec_trans=torch.tensor([0.6, 0.5, 0.0]),
        emission=m.emission._replace(x=torch.tensor([0.0, 0.2, 0.0])),
    )
    return p._replace(materials=m)


CASES = {
    "verbatim": (lambda: make_scene(), 1, VERBATIM),
    "spp2": (lambda: make_scene(), 2, VERBATIM),
    "fixed": (lambda: make_scene(), 1, FIXED),
    "depth8_respect_max_dist": (lambda: make_scene(recursion_depth=8, respect_max_dist=True), 1, FIXED),
    "three_light_types": (lambda: make_scene(lights=_three_lights()), 1, VERBATIM),
    "alpha_and_transmission": (lambda: make_scene(params=_alpha_glass_params()), 2, FIXED),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_code_matches_plain_version(host_lib, case):
    make, spp, quirks = CASES[case]
    scene = make()
    key = rng.prng_key(sorted(CASES).index(case) + 11)
    img = host_render(host_lib, scene, key, 96, 64, spp, quirks).numpy()
    ref = MK.render_frame_reference(scene, key, 96, 64, spp, quirks).numpy()
    assert np.isfinite(img).all()
    diff = np.abs(img.astype(np.float64) - ref)
    assert np.quantile(diff, 0.999) < 1e-4
    assert diff.mean() < 1e-5

