// Forward path-tracing megakernel (K1) on Hopper, generic over the scene
// backend: the analytical scene (analytical.cuh), the sphere-traced SDF
// scene (sdf.cuh, the port of the SDF backend K5), the small triangle mesh
// (mesh.cuh, K7) and the big one (bigmesh.cuh, K8); and its instrumented
// twin, the occupancy kernel K3, on the same four backends. This header
// holds the template; megakernel_fwd.cu instantiates it for the analytical,
// mesh and big mesh backends, megakernel_sdf.cu for the SDF backend of one
// scene's primitive counts.
//
// Replaces the TPU kernel pathtracer_tpu/ops/megakernel.py::_pallas_forward
// (body _make_kernel -> _trace_tile -> _tile_bounce, over a KernelBackend).
// K3 replaces _pallas_forward_occupancy (_make_kernel(instrument=True) ->
// _trace_tile_counts), which adds, per tile of 8 x 128 lanes, the lanes
// alive entering each bounce. Here K3 renders each pixel exactly as K1
// does and also writes, per sample, the bounces its path entered alive (the
// trips of its bounce loop) into an int32 [spp, H, W] array: any tiling
// (the TPU's tiles, this card's blocks and warps) reduces from it exactly,
// and the loop and its early exit stay K1's. K1's instantiation compiles no
// count (COUNT = false), as it compiles no triangle table outside the mesh.
// A scene whose material table declares a medium takes the MEDIA
// instantiation of both (_make_kernel with has_media: the segment inside a
// medium, the Scatter event, the medium transition; tracer.cuh), its own
// entry points over 26-scalar material records; the media-free
// instantiations compile none of it.
// It computes what integrator/tracer.render_frame computes for one frame:
// per pixel, for each of the spp samples, the camera ray and up to `depth`
// bounces of closest hit, emitter pass with MIS, background, alpha
// pass-through, NEE with a shadow ray and the four-lobe Disney sample, then
// the mean over samples into the [H, W, 4] frame (alpha 1).
//
// Random numbers are threefry2x32 drawn in the kernel at the same flat
// counters as ops/rng: camera uniform j of pixel p is uniform(kc)[p*2 + j],
// bounce uniform j at depth d is uniform(kb)[(d*N + p)*8 + j], N = W*H,
// with (kc, kb) = split(k_s) of each sample's key, precomputed on the host.
// The counters are per pixel and bounce, so which thread runs a path, and
// when, changes no number: a dead path stops where the Python code freezes
// its lane, and the two agree.
//
// What bounds it on this card: issue, not bytes. Each ray reads the packed
// scene (112 floats for the analytical demo; copied to shared memory per
// block) and writes 16 bytes; everything else is per-thread math with
// data-dependent branches. One thread a pixel looping over its bounces
// (the per-thread loop, trace_sample) leaves a warp's lanes idle once their
// paths die (26-28% of a live warp's lane slots at depth 4, 35% in the media
// frame) and runs both sides of each bounce's branches in turn: the lanes
// that missed or hit a light wait while the others shade, and under MEDIA a
// scatter lane's HG phase and a surface lane's Disney BSDF take turns. So a
// backend whose Tiling says so runs the compacted loop (render_tile): a
// block keeps its tile's paths in shared memory (tracer.cuh Tile) and runs
// them level by level, each bounce as two phases over lists of paths
// compacted by warp ballots and a block scan (compact): the live paths'
// segments (closest hit, emitter pass, background, the medium's segment and
// free flight; tracer.cuh segment), then the shades of the paths that need
// one (NEE, the Disney or HG sample; tracer.cuh shade), scatter points
// before surfaces. Full warps run each phase, and a dead path costs no lane.
// Larger tiles fill more warps: the analytical scene's 1536 paths a block
// of 512 threads, one block an SM (its registers and shared memory), took
// 0.42 of the per-thread loop's time and the media frame 0.23 (tools/k1_pair
// on an H100 80GB HBM3 at 700 W), and the small mesh takes the same tile.
// On the SDF scene the march dominates: up to 96 distance evaluations per
// ray, a warp marching until its slowest lane is done, each evaluation a
// chain of square roots over the primitives; K5 is therefore built for the
// scene's primitive counts, so the field unrolls, its records sit at fixed
// offsets and the primitives' chains interleave (sdf.cuh,
// megakernel_sdf.cu), and its compacted tiles are small (256
// paths, 128 threads: the march holds more registers). On the mesh scenes
// the triangle tests do: 20 per ray for the small mesh (each block stages
// a table of its triangles' first vertices, edges and normals in shared
// memory beside the packed vector, mesh.cuh), and 128 for each chunk of the
// big mesh that the ray's box test admits, a warp running the union of its
// lanes' chunks, each pair a dependent chain from its row's load to its
// guard (bigmesh.cuh reads the rows as float4, several at once); the big
// mesh keeps the per-thread loop.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "analytical.cuh"
#include "bigmesh.cuh"
#include "mesh.cuh"
#include "sdf.cuh"
#include "tracer.cuh"

namespace pt {

// The per-thread loop's block: one pixel a thread.
constexpr int THREADS = 128;

// How K1 and K3 run a backend's paths, with and without the medium: level
// by level over each block's tile of `paths` pixels with `threads`
// threads, or (paths = 0) the per-thread loop. tools/k1_pair times each
// backend's instantiations against another tree. The analytical scene's
// bounces are cheap, so its tiles are large (the more paths a tile
// compacts, the fuller its warps); the SDF march holds more registers
// (compacted, its MEDIA instantiation spills 32 B and still takes 0.74 of
// its per-thread loop's time, tools/k1_pair on an H100 80GB HBM3 at 700 W).
// The small mesh (megakernel_mesh.cu) takes the analytical scene's tile,
// the fastest of those tools/k1_pair timed for it (PERF.md). The big mesh
// keeps the per-thread loop: compacted, its frames moved in the last bits.
template <class B>
struct Tiling {
  static constexpr int threads = THREADS, paths = 0;
};
template <>
struct Tiling<Analytical> {
  static constexpr int threads = 512, paths = 1536;
};
template <class C>
struct Tiling<Sdf<C>> {
  static constexpr int threads = 128, paths = 256;
};
template <>
struct Tiling<Mesh> {
  static constexpr int threads = 512, paths = 1536;
};

template <class B>
constexpr int TILE_PATHS = Tiling<B>::paths;
template <class B>
constexpr bool COMPACTED = TILE_PATHS<B> > 0;
template <class B>
constexpr int BLOCK_THREADS = Tiling<B>::threads;

// Where a block's tile starts in dynamic shared memory: after the packed
// vector and the triangle table (mesh.cuh), 16-byte aligned.
__host__ __device__ inline size_t tile_offset(int n_sv, int n_tris) {
  return align16(table_end((size_t)n_sv * sizeof(float), n_tris));
}

// A launch's dynamic shared memory a block: the packed vector, the
// triangle table and, compacted, the tile.
template <class B, bool MEDIA>
size_t forward_smem_bytes(int n_sv, int n_tris) {
  if constexpr (COMPACTED<B>) {
    return tile_offset(n_sv, n_tris) + sizeof(Tile<MEDIA, TILE_PATHS<B>>);
  } else {
    return table_end((size_t)n_sv * sizeof(float), n_tris);
  }
}

// K1's (and K3's) layout for n_sv scalars and n_tris triangles, into
// out[2]: its dynamic shared bytes a block and its tile's paths (0: the
// per-thread loop). No call to the card: the host refuses a scene whose
// shared memory the card cannot give before it launches.
template <class B, bool MEDIA>
void forward_layout(int n_sv, int n_tris, long long* out) {
  out[0] = (long long)forward_smem_bytes<B, MEDIA>(n_sv, n_tris);
  out[1] = TILE_PATHS<B>;
}

// Lists in t.list, in the order of their places in the tile, the paths
// whose outcome is `first`, then those whose outcome is `second` (-1:
// none); returns how many in all. Each warp ballots its rounds of paths,
// and every thread sums the warps' counts before its own (t.counts), so the
// list keeps the tile's order. Every thread of the block (T of them) calls
// it; it starts and ends at a barrier.
template <int T, bool MEDIA, int P>
__device__ __forceinline__ int compact(Tile<MEDIA, P>& t, int first, int second) {
  constexpr int W = T / 32, R = P / T, G = R * W;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  unsigned a[R], b[R];
  __syncthreads();  // the phase before has written its outcomes
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int o = t.outcome[r * T + threadIdx.x];
    a[r] = __ballot_sync(~0u, o == first);
    b[r] = __ballot_sync(~0u, o == second);
    if (lane == 0) {
      t.counts[r * W + warp] = __popc(a[r]);
      t.counts[G + r * W + warp] = __popc(b[r]);
    }
  }
  __syncthreads();
  int na = 0, nb = 0, before_a[R], before_b[R];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (g % W == warp) {
      before_a[g / W] = na;
      before_b[g / W] = nb;
    }
    na += t.counts[g];
    nb += t.counts[G + g];
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = r * T + threadIdx.x;
    if ((a[r] >> lane) & 1u) t.list[before_a[r] + __popc(a[r] & below)] = i;
    if ((b[r] >> lane) & 1u) t.list[na + before_b[r] + __popc(b[r] & below)] = i;
  }
  __syncthreads();
  return na + nb;
}

// The compacted loop of one block: its tile's P paths, for each sample in
// turn, level by level. At bounce d the block lists its live paths and runs
// their segments, thread j taking entry j (and j + T, ...), then lists the
// paths to shade, the MEDIA instantiation's scatter points before its
// surfaces, so that at most one warp mixes the two, and runs their shades.
// A dead path waits in shared memory; after each sample the block adds
// its paths' radiance to their pixels in the frame (and with COUNT writes
// the bounces they entered), and at the end divides by the samples.
template <class B, bool COUNT, bool MEDIA, int T, int P>
__device__ __forceinline__ void render_tile(const SceneView& s, Tile<MEDIA, P>& t, const uint32_t* __restrict__ keys,
                                            float* __restrict__ out, int* __restrict__ entered, int width, int height,
                                            int spp, int depth, int flags) {
  static_assert(T % 32 == 0 && P % T == 0, "a tile is whole rounds of whole warps");
  const int n = width * height;
  const int p0 = blockIdx.x * P;
  for (int k = 0; k < spp; ++k) {
    const uint32_t* kk = keys + 4 * k;  // (kc0, kc1, kb0, kb1) of sample k
    for (int i = threadIdx.x; i < P; i += T) start_tile_path(s, t, i, p0 + i, n, width, height, flags, kk[0], kk[1]);
    for (int d = 0; d < depth; ++d) {
      const int live = compact<T>(t, LIVE, -1);
      if (live == 0) break;
      for (int j = threadIdx.x; j < live; j += T) {
        const int i = t.list[j];
        segment_tile_path<B, COUNT>(s, t, i, p0 + i, n, d, flags, kk[2], kk[3]);
      }
      const int shaded = compact<T>(t, SCATTER, SURFACE);
      for (int j = threadIdx.x; j < shaded; j += T) {
        const int i = t.list[j];
        shade_tile_path<B>(s, t, i, p0 + i, n, d, kk[2], kk[3]);
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < P && p0 + i < n; i += T) {
      end_tile_sample(t, i, k, out + 4 * (p0 + i));
      if constexpr (COUNT) entered[k * n + p0 + i] = t.entered[i];
    }
  }
  if (spp > 1) {
    for (int i = threadIdx.x; i < P && p0 + i < n; i += T) {
      float4& o = reinterpret_cast<float4*>(out)[p0 + i];
      const V3 mean = v3(o.x, o.y, o.z) / (float)spp;
      o = make_float4(mean.x, mean.y, mean.z, 1.0f);
    }
  }
}

template <class B, bool COUNT, bool MEDIA>
__global__ void __launch_bounds__(BLOCK_THREADS<B>)
    render_forward_kernel(const float* __restrict__ sv_global, int n_sv, const uint32_t* __restrict__ keys,
                          float* __restrict__ out, int* __restrict__ entered, int width, int height, int spp,
                          int depth, int flags, SceneView s) {
  extern __shared__ __align__(16) float sv[];
  for (int i = threadIdx.x; i < n_sv; i += blockDim.x) sv[i] = sv_global[i];
  // The small mesh's triangle table beside the packed vector; the other
  // backends have none, and their instantiations compile no staging.
  if constexpr (STAGED_TABLE<B>) {
    float4* table = reinterpret_cast<float4*>(reinterpret_cast<char*>(sv) + align16(n_sv * sizeof(float)));
    for (int i = threadIdx.x; i < s.n_tris; i += blockDim.x) stage_mesh_triangle(sv_global, s.topo, i, table);
    s.tris = table;
  }
  __syncthreads();
  s.sv = sv;

  if constexpr (COMPACTED<B>) {
    using T = Tile<MEDIA, TILE_PATHS<B>>;
    T& t = *reinterpret_cast<T*>(reinterpret_cast<char*>(sv) + tile_offset(n_sv, s.n_tris));
    render_tile<B, COUNT, MEDIA, BLOCK_THREADS<B>>(s, t, keys, out, entered, width, height, spp, depth, flags);
  } else {  // one thread a pixel, its samples in turn
    const int n = width * height;
    const int p = blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= n) return;
    V3 sum = splat3(0.0f);
    for (int k = 0; k < spp; ++k) {
      const uint32_t* kk = keys + 4 * k;
      int e = 0;  // the bounces entered, which K1 (COUNT = false) neither counts nor writes
      V3 r = trace_sample<B, COUNT, MEDIA>(s, p, n, width, height, depth, flags, kk[0], kk[1], kk[2], kk[3], &e);
      if constexpr (COUNT) entered[k * n + p] = e;
      sum = k == 0 ? r : sum + r;
    }
    if (spp > 1) sum = sum / (float)spp;
    reinterpret_cast<float4*>(out)[p] = make_float4(sum.x, sum.y, sum.z, 1.0f);
  }
}

// One frame on `stream` through K1's (K3's with COUNT) instantiation: a
// block a tile, or a block of THREADS pixels; `s` is the scene's structure
// (its sv and triangle table are set to the block's copies in the kernel).
// Returns cudaGetLastError().
template <class B, bool MEDIA, bool COUNT>
int launch_one(const float* sv, int n_sv, const uint32_t* keys, float* out, int* entered, int width, int height,
               int spp, int depth, int flags, SceneView s, cudaStream_t stream) {
  const auto kernel = render_forward_kernel<B, COUNT, MEDIA>;
  const size_t smem = forward_smem_bytes<B, MEDIA>(n_sv, s.n_tris);
  const int pixels = COMPACTED<B> ? TILE_PATHS<B> : THREADS;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<(width * height + pixels - 1) / pixels, BLOCK_THREADS<B>, smem, stream>>>(
      sv, n_sv, keys, out, entered, width, height, spp, depth, flags, s);
  return (int)cudaGetLastError();
}

// The resources of K1's (K3's with COUNT) instantiation for n_sv scalars
// and n_tris triangles, into out[4]: registers, stack bytes a thread,
// dynamic shared bytes a block, blocks an SM (the occupancy calculator).
template <class B, bool MEDIA, bool COUNT>
int forward_resources(int n_sv, int n_tris, int* out) {
  const auto kernel = render_forward_kernel<B, COUNT, MEDIA>;
  const size_t smem = forward_smem_bytes<B, MEDIA>(n_sv, n_tris);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  cudaFuncAttributes a;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&a, kernel);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out + 3, kernel, BLOCK_THREADS<B>, smem);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)smem;
  return 0;
}

// Launches one frame on `stream`: K1, or K3 when `entered` (int32 [spp, H,
// W]) is given; MEDIA selects the media instantiation.
template <class B, bool MEDIA = false>
int launch_forward(const float* sv, int n_sv, const uint32_t* keys, float* out, int* entered, int width,
                   int height, int spp, int depth, int flags, SceneView s, void* stream) {
  if (entered == nullptr) {
    return launch_one<B, MEDIA, false>(sv, n_sv, keys, out, nullptr, width, height, spp, depth, flags, s,
                                       (cudaStream_t)stream);
  }
  return launch_one<B, MEDIA, true>(sv, n_sv, keys, out, entered, width, height, spp, depth, flags, s,
                                    (cudaStream_t)stream);
}

}  // namespace pt
