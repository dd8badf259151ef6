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

The compacted K1 (`csrc/megakernel_fwd.cuh render_tile`) runs the same
bounce as two phases over lists of a tile's paths in shared memory. TILED
runs that schedule on the host, tile by tile (`pt::Tile`, the kernel's own
per-path functions): per level it lists the live paths, runs their
segments, lists the paths to shade (scatter points before surfaces) and
runs their shades, each list in an order shuffled from a seed, where the
kernel's threads take them in the tile's order. Its frames and counts are
held bit for bit to `trace_sample`'s, which no thread order changes, on
the analytical scene and on the small mesh (its triangle table staged as
the kernels' blocks stage it, MESH_VIEW), with and without the medium.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from pathtracer_tpu_torch.integrator import tracer as T
from pathtracer_tpu_torch.integrator.tracer import FIXED, VERBATIM
from pathtracer_tpu_torch.models import light as L
from pathtracer_tpu_torch.models import mesh
from pathtracer_tpu_torch.models.analytical import default_params, make_scene
from pathtracer_tpu_torch.models.material import MediumType
from pathtracer_tpu_torch.ops import _build, megakernel as MK
from pathtracer_tpu_torch.ops import rng
from pathtracer_tpu_torch.ops.megakernel_mesh import hit_ties

# The per-thread headers are plain C++ behind these definitions.
PRELUDE = r"""
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#define __device__
#define __host__
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
struct float4 {
  float x, y, z, w;
};
// The SDF backend is a template over the scene's primitive counts; a shim is
// built for these (the demo scene's, and the scene with a twin sphere of
// tests/test_torch_sdf_kernel_bwd_host.py) and runs its body with C the
// scene's counts, or aborts.
#define SDF_SHIM_COUNTS pt::SdfCounts<1, 1, 1>, pt::SdfCounts<2, 1, 1>
#define WITH_SDF_COUNTS(n_s, n_b, n_t, ...)                                                     \
  if (!pt::with_sdf_counts<SDF_SHIM_COUNTS>(n_s, n_b, n_t, [&](auto counts_) {                 \
        using C = decltype(counts_);                                                            \
        __VA_ARGS__;                                                                            \
      }))                                                                                       \
  std::abort()
"""

# The compacted K1's schedule on the host (megakernel_fwd.cuh render_tile):
# each tile of TILE_PATHS pixels, its samples in turn, level by level; every
# list run in an order shuffled from `seed` (Fisher-Yates on mt19937), the
# scatter points still before the surfaces; `entered` gets each sample's
# bounces entered (K3's counts).
TILED = r"""
#include <memory>
#include <random>
#include <utility>

constexpr int TILE_PATHS = 256;

template <class B, bool MEDIA>
static void tiled_frame(const pt::SceneView& s, const uint32_t* keys, float* out, int* entered, int width,
                        int height, int spp, int depth, int flags, uint32_t seed) {
  constexpr int P = TILE_PATHS;
  auto tile = std::make_unique<pt::Tile<MEDIA, P>>();
  pt::Tile<MEDIA, P>& t = *tile;
  std::mt19937 gen(seed);
  auto shuffle = [&](int* a, int m) {
    for (int j = m - 1; j > 0; --j) std::swap(a[j], a[gen() % (uint32_t)(j + 1)]);
  };
  auto list = [&](int outcome, int at) {
    for (int i = 0; i < P; ++i) {
      if (t.outcome[i] == outcome) t.list[at++] = i;
    }
    return at;
  };
  const int n = width * height;
  for (int p0 = 0; p0 < n; p0 += P) {
    for (int k = 0; k < spp; ++k) {
      const uint32_t* kk = keys + 4 * k;
      for (int i = 0; i < P; ++i) pt::start_tile_path(s, t, i, p0 + i, n, width, height, flags, kk[0], kk[1]);
      for (int d = 0; d < depth; ++d) {
        const int live = list(pt::LIVE, 0);
        if (live == 0) break;
        shuffle(t.list, live);
        for (int j = 0; j < live; ++j) {
          const int i = t.list[j];
          pt::segment_tile_path<B, true>(s, t, i, p0 + i, n, d, flags, kk[2], kk[3]);
        }
        const int scatter = list(pt::SCATTER, 0), shaded = list(pt::SURFACE, scatter);
        shuffle(t.list, scatter);
        shuffle(t.list + scatter, shaded - scatter);
        for (int j = 0; j < shaded; ++j) {
          const int i = t.list[j];
          pt::shade_tile_path<B>(s, t, i, p0 + i, n, d, kk[2], kk[3]);
        }
      }
      for (int i = 0; i < P && p0 + i < n; ++i) {
        pt::end_tile_sample(t, i, k, out + 4 * (p0 + i));
        entered[k * n + p0 + i] = t.entered[i];
      }
    }
    for (int i = 0; i < P && p0 + i < n && spp > 1; ++i) {
      float* o = out + 4 * (p0 + i);
      const pt::V3 mean = pt::v3(o[0], o[1], o[2]) / (float)spp;
      o[0] = mean.x;
      o[1] = mean.y;
      o[2] = mean.z;
    }
  }
}
"""

# The small mesh's view on the host (after mesh.cuh): its triangle table
# staged as each block of the kernels stages it (mesh.cuh
# stage_mesh_triangle), valid until the next call.
MESH_VIEW = r"""
#include <vector>

static pt::SceneView host_mesh_view(const float* sv, int n_lights, int n_materials, const int* topo, int n_tris,
                                    int n_verts) {
  static std::vector<float4> table;
  table.assign((size_t)pt::MESH_ROWS * n_tris, float4{});
  for (int i = 0; i < n_tris; ++i) pt::stage_mesh_triangle(sv, topo, i, table.data());
  pt::SceneView s = pt::mesh_view(sv, n_lights, n_materials, topo, n_tris, n_verts);
  s.tris = table.data();
  return s;
}
"""

SHIM = PRELUDE + r"""
#include "analytical.cuh"
#include "mesh.cuh"
#include "tracer.cuh"
""" + TILED + MESH_VIEW + r"""

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

// K3's per-thread counts: the bounces each sample's path entered (trace_sample with COUNT).
extern "C" void host_counts(const float* sv, const uint32_t* keys, int* entered, int width, int height, int spp,
                            int depth, int n_lights, int n_materials, int flags) {
  const int n = width * height;
  const pt::SceneView s = pt::analytical_view(sv, n_lights, n_materials, (flags & pt::FLAG_RESPECT_MAX_DIST) != 0);
  for (int p = 0; p < n; ++p) {
    for (int k = 0; k < spp; ++k) {
      const uint32_t* kk = keys + 4 * k;
      pt::trace_sample<pt::Analytical, true>(s, p, n, width, height, depth, flags, kk[0], kk[1], kk[2], kk[3],
                                             entered + k * n + p);
    }
  }
}

// The same frame through the compacted schedule (TILED), with its counts.
extern "C" void host_render_tiled(const float* sv, const uint32_t* keys, float* out, int* entered, int width,
                                  int height, int spp, int depth, int n_lights, int n_materials, int flags,
                                  uint32_t seed) {
  const pt::SceneView s = pt::analytical_view(sv, n_lights, n_materials, (flags & pt::FLAG_RESPECT_MAX_DIST) != 0);
  tiled_frame<pt::Analytical, false>(s, keys, out, entered, width, height, spp, depth, flags, seed);
}

// The small mesh's frame and K3 counts (MEDIA with `media`) through the
// per-thread loop (trace_sample) or, with `tiled`, the compacted schedule
// (TILED, its lists shuffled from `seed`), on its staged triangle table.
template <bool MEDIA>
static void mesh_frame(const pt::SceneView& s, const uint32_t* keys, float* out, int* entered, int width, int height,
                       int spp, int depth, int flags, int tiled, uint32_t seed) {
  if (tiled) return tiled_frame<pt::Mesh, MEDIA>(s, keys, out, entered, width, height, spp, depth, flags, seed);
  const int n = width * height;
  for (int p = 0; p < n; ++p) {
    pt::V3 sum = pt::splat3(0.0f);
    for (int k = 0; k < spp; ++k) {
      const uint32_t* kk = keys + 4 * k;
      pt::V3 r = pt::trace_sample<pt::Mesh, true, MEDIA>(s, p, n, width, height, depth, flags, kk[0], kk[1], kk[2],
                                                         kk[3], entered + k * n + p);
      sum = k == 0 ? r : sum + r;
    }
    if (spp > 1) sum = sum / (float)spp;
    out[4 * p + 0] = sum.x;
    out[4 * p + 1] = sum.y;
    out[4 * p + 2] = sum.z;
    out[4 * p + 3] = 1.0f;
  }
}

extern "C" void host_mesh_frame(const float* sv, const uint32_t* keys, float* out, int* entered, int width,
                                int height, int spp, int depth, int n_lights, int n_materials, int flags,
                                const int* topo, int n_tris, int n_verts, int media, int tiled, uint32_t seed) {
  const pt::SceneView s = host_mesh_view(sv, n_lights, n_materials, topo, n_tris, n_verts);
  (media ? mesh_frame<true> : mesh_frame<false>)(s, keys, out, entered, width, height, spp, depth, flags, tiled,
                                                  seed);
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
    lib.host_render_tiled.argtypes = [p, p, p, p, i, i, i, i, i, i, i, ctypes.c_uint32]
    lib.host_counts.argtypes = [p, p, p, i, i, i, i, i, i, i]
    lib.host_mesh_frame.argtypes = [p, p, p, p, i, i, i, i, i, i, i, p, i, i, i, i, ctypes.c_uint32]
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



def host_render_tiled(lib, scene, key, w, h, spp, quirks, seed):
    """host_render through the compacted schedule, its lists shuffled from
    `seed`: (the frame, the bounces each sample's path entered, int32
    [spp, H, W])."""
    sv = MK.pack_scene(scene, w, h).contiguous()
    keys = launch_keys(key, spp)
    out = torch.empty((h, w, 4), dtype=torch.float32)
    entered = torch.zeros((spp, h, w), dtype=torch.int32)
    lib.host_render_tiled(
        sv.data_ptr(), keys.data_ptr(), out.data_ptr(), entered.data_ptr(), w, h, spp,
        scene.recursion_depth, scene.num_lights, int(scene.params.materials.roughness.shape[0]),
        MK.kernel_flags(scene, quirks), seed,
    )
    return out, entered


def host_counts(lib, scene, key, w, h, spp, quirks):
    """K3's counts from the per-thread loop on the host, int32 [spp, H, W]."""
    sv = MK.pack_scene(scene, w, h).contiguous()
    keys = launch_keys(key, spp)
    entered = torch.zeros((spp, h, w), dtype=torch.int32)
    lib.host_counts(sv.data_ptr(), keys.data_ptr(), entered.data_ptr(), w, h, spp, scene.recursion_depth,
                    scene.num_lights, int(scene.params.materials.roughness.shape[0]), MK.kernel_flags(scene, quirks))
    return entered


def host_mesh_frame(lib, scene, key, w, h, spp, quirks, seed=None):
    """The small mesh's frame and K3 counts on the host, through the
    per-thread loop or, with a `seed`, the compacted schedule (its lists
    shuffled from it); the MEDIA instantiation for a scene with a medium."""
    b, media = MK.BACKENDS["mesh"], MK.scene_media(scene)
    # held: the library reads their memory
    sv, keys, extras = b.pack(scene, w, h, media).contiguous(), launch_keys(key, spp), b.extras(scene)
    out = torch.empty((h, w, 4), dtype=torch.float32)
    entered = torch.zeros((spp, h, w), dtype=torch.int32)
    lib.host_mesh_frame(
        sv.data_ptr(), keys.data_ptr(), out.data_ptr(), entered.data_ptr(), w, h, spp, scene.recursion_depth,
        scene.num_lights, int(scene.params.materials.roughness.shape[0]), MK.kernel_flags(scene, quirks),
        *(t.data_ptr() for t in extras), *b.counts(scene), int(media), int(seed is not None), seed or 0,
    )
    return out, entered


def mesh_glass():
    """The mesh demo at depth 6 with its cube (material 1) glass and filled
    with the Scatter demo's medium (tests/test_torch_media_kernel_host.py
    media_scene)."""
    scene = mesh.make_scene(recursion_depth=6)
    m = scene.params.materials
    with torch.no_grad():
        m.spec_trans[1], m.metallic[1], m.roughness[1], m.ior[1] = 1.0, 0.0, 0.05, 1.5
        med = m.medium
        med.medium_type[1], med.density[1], med.anisotropy[1] = int(MediumType.SCATTER), 0.8, 0.4
        med.color.x[1], med.color.y[1], med.color.z[1] = 0.9, 0.2, 0.1
    return scene


# The small mesh's cases of the compacted schedule, with and without MEDIA.
MESH_CASES = {
    "mesh": (lambda: mesh.make_scene(), 1, VERBATIM),
    "mesh_spp2_fixed": (lambda: mesh.make_scene(), 2, FIXED),
    "mesh_media_scatter": (mesh_glass, 1, VERBATIM),
}


@pytest.mark.parametrize("case", sorted(CASES) + sorted(MESH_CASES))
def test_compacted_schedule_matches_per_thread_loop(host_lib, case):
    """The compacted K1's schedule, its lists in a shuffled order (99x65:
    26 tiles of 256 paths, the last one part empty), on the analytical
    scene and the small mesh (its staged triangle table; MEDIA on the glass
    cube): each pixel's radiance and its K3 counts bit for bit the
    per-thread loop's (trace_sample), the counts also the plain version's
    (tracer.bounces_entered), and the frame within the plain version's
    image gate, the pixels of a coplanar tie on the mesh left out
    (ops/megakernel_mesh.hit_ties). Under 1 s an analytical case, 2-6 s a
    mesh one (most of it the plain version's)."""
    make, spp, quirks = {**CASES, **MESH_CASES}[case]
    scene = make()
    index = (sorted(CASES) + sorted(MESH_CASES)).index(case)
    key = rng.prng_key(index + 11)
    seed = int(np.random.default_rng(index).integers(2**32))
    w, h = 99, 65
    ties = torch.zeros((h, w), dtype=torch.bool)
    if case in MESH_CASES:
        img, entered = host_mesh_frame(host_lib, scene, key, w, h, spp, quirks, seed)
        per_thread, per_thread_entered = host_mesh_frame(host_lib, scene, key, w, h, spp, quirks)
        assert torch.equal(img, per_thread)
        assert torch.equal(entered, per_thread_entered)
        ties = (hit_ties(scene, key, w, h, spp, quirks) < 1e-6).any(1).any(0).reshape(h, w)
        assert ties.double().mean() < 0.05
    else:
        img, entered = host_render_tiled(host_lib, scene, key, w, h, spp, quirks, seed)
        assert torch.equal(img, host_render(host_lib, scene, key, w, h, spp, quirks))
        assert torch.equal(entered, host_counts(host_lib, scene, key, w, h, spp, quirks))
    assert torch.equal(entered[:, ~ties], T.bounces_entered(scene, key, w, h, spp, quirks)[:, ~ties])
    ref = MK.render_frame_reference(scene, key, w, h, spp, quirks).numpy()
    diff = np.abs(img.numpy().astype(np.float64) - ref)[~ties.numpy()]
    assert np.quantile(diff, 0.999) < 1e-4
    assert diff.mean() < 1e-5
