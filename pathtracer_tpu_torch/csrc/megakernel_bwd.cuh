// Backward path-tracing megakernel (K2) on Hopper, generic over the scene
// backend as K1 is: the analytical scene (analytical_adj.cuh), the
// sphere-traced SDF scene (sdf_adj.cuh, the adjoint of K5, built for the
// scene's primitive counts in megakernel_sdf.cu and
// megakernel_sdf_bwd_media.cu) and the small triangle mesh (mesh_adj.cuh,
// the adjoint of K7). The big mesh (K8) has
// none: the JAX package differentiates it through its XLA twin. A scene
// whose material table declares a medium takes the MEDIA instantiation
// (`_make_grad_kernel(has_media=True)`'s counterpart: tracer_adj.cuh's
// media_bounce_adj over 26-scalar material records) on each of the three,
// built apart without FMA contraction (megakernel_bwd_media.cu). This
// header holds the template; megakernel_bwd.cu and megakernel_bwd_media.cu
// instantiate it.
//
// Replaces the TPU kernel pathtracer_tpu/ops/megakernel.py::_pallas_backward
// (body _make_grad_kernel: replay, stored carries, per-bounce VJP in
// reverse, raygen VJP). It computes d(loss)/d(packed scene) [P] from the
// cotangent of the frame K1 renders, under the detached-sampling estimator
// of integrator/tracer.render_frame(detach=True); csrc/tracer_adj.cuh holds
// the per-thread code. The cotangent is grad_out[..., :3] / spp; the alpha
// channel gets none.
//
// Two kernels and a reduction, launched in turn on one stream:
//
// 1. record_kernel has K1's shape: one thread a pixel loops over its
//    samples and traces each path once with K1's in-kernel threefry
//    counters (the same numbers for the same keys), through tracer_adj.cuh's
//    record_sample, which is K1's bounce without the radiance. Per sample
//    and bounce it writes a record of Record<MEDIA>::WORDS words (18, 24
//    with the medium: the carry entering the bounce, the closest hit's t
//    and winner, the light the emitter pass hit and its distance, the NEE's
//    light and shadow verdict, and with MEDIA the medium and whether it
//    scattered) to device memory as [sample][bounce][word][pixel], so a
//    warp's stores and loads are coalesced, and the bounces each path
//    entered as [sample][pixel].
// 2. adjoint_kernel: one thread a pixel reads its records and runs each
//    sample's bounce adjoints in reverse, then the camera ray's
//    (adjoint_sample). It intersects nothing: no closest hit, no march, no
//    triangle loop, no emitter search, no shadow ray. Each thread adds into
//    its own column of a [P][THREADS+1] shared-memory table (padded against
//    bank conflicts), so no atomics; the small mesh's triangle table (K1's,
//    mesh.cuh) follows it (over 48 KB for the demo mesh: the launch opts in
//    to more). The block then sums each row in thread order into
//    partial[block][P].
// 3. reduce_blocks_kernel sums the blocks of each entry in a fixed order
//    (in double). The gradient is the same bit for bit from run to run.
//
// Each is an entry point of its own (launch_record, launch_adjoint and the
// reduction), and ops/megakernel.launch_backward runs the chunk loop. The
// record buffer never exceeds REC_CAP_BYTES: record_plan takes the
// samples, and where one sample of the frame does not fit the pixels (in
// whole blocks), in chunks; each chunk is one launch of each kernel, and
// a later sample chunk adds its block sums to the earlier ones'. At
// 1920x1080 one sample's records take 73 words a pixel at depth 4 (0.61 GB)
// and 145 with the medium at depth 6 (1.20 GB), so the frame is one chunk
// of each kernel; depth has no limit but the cap (one block's pixels of one
// sample must fit: about 230,000 bounces, 170,000 with the medium).
//
// What bounds it on this card: operations and divergence in the adjoint
// kernel. The adjoint of a bounce is several thousand float32 operations a
// lane with data-dependent branches (the adjoints of disney_sample and
// disney_eval are most of them; bsdf_adj.cuh runs each BSDF forward once,
// inside its adjoint), and its live state needs far more registers than
// K1's: __launch_bounds__(BWD_THREADS, BWD_MIN_BLOCKS) holds it to 3
// blocks of 128 an SM (168 registers, some spilled), the most the gradient
// table allows at P = 112; on the H100 that takes 0.96-1.01 of the time
// of 2 blocks without spills (tools/k2_pair.py against a tree built with
// __launch_bounds__(BWD_THREADS) alone), so occupancy is not what bounds
// it either. The record kernel is K1
// without the radiance and the NEE's BSDF evaluation, at K1's occupancy;
// its bytes (the records written once and read once) take well under a
// millisecond at 3.35 TB/s. What this design does against the one it
// replaces (which replayed the path in the adjoint's own thread and re-ran
// each bounce's forward, its intersections included, before its adjoint):
// every intersection of the path is traced once, in a kernel with K1's
// registers; the stored carries leave the thread's stack for coalesced
// device memory, which also lifts the old limit of 16 bounces; and the
// adjoint's registers no longer hold a forward sweep beside it.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "analytical_adj.cuh"
#include "mesh_adj.cuh"
#include "sdf_adj.cuh"
#include "tracer_adj.cuh"

namespace pt {

constexpr int BWD_THREADS = 128;  // both kernels' threads a block: a record chunk is whole adjoint blocks
constexpr int BWD_MIN_BLOCKS = 3;  // the adjoint kernel's blocks an SM (<= 168 registers)
constexpr int ACC_STRIDE = BWD_THREADS + 1;
constexpr int REDUCE_THREADS = 256;
constexpr size_t REC_CAP_BYTES = size_t(1) << 31;  // the record buffer's cap, 2 GiB

// Dynamic shared memory of one block: the packed vector and the triangle
// table of n_tris triangles (mesh.cuh; the record kernel), with the
// gradient table between them (the adjoint kernel).
inline size_t record_smem_bytes(int n_sv, int n_tris) { return table_end((size_t)n_sv * sizeof(float), n_tris); }
inline size_t backward_smem_bytes(int n_sv, int n_tris) {
  return table_end((size_t)n_sv * (1 + ACC_STRIDE) * sizeof(float), n_tris);
}

// How a record buffer of at most `cap` bytes (REC_CAP_BYTES at most; a
// test passes less to make chunks of a small frame) takes
// a frame of n pixels and spp samples: chunks of `pixels` pixels (a
// multiple of BWD_THREADS, or all n) and `samples` samples; samples 0
// where not even one block's pixels of one sample fit.
struct RecordPlan {
  int pixels, samples;
};

inline RecordPlan record_plan(int n, int spp, int depth, int words, size_t cap) {
  cap = std::min(cap, REC_CAP_BYTES);
  const size_t per = ((size_t)depth * words + 1) * sizeof(float);  // one pixel's sample: records and length
  if (per * n <= cap) return {n, (int)std::min((size_t)spp, cap / (per * n))};
  const size_t pixels = cap / per / BWD_THREADS * BWD_THREADS;
  return {(int)pixels, pixels > 0 ? 1 : 0};
}

// The bytes of the record buffer for plan `pl`.
inline size_t record_bytes(const RecordPlan& pl, int depth, int words) {
  return (size_t)pl.pixels * pl.samples * ((size_t)depth * words + 1) * sizeof(float);
}

// Copies the packed vector to shared memory (and stages the mesh's
// triangle table at `table`) and points `s` at the copies.
template <class B>
__device__ __forceinline__ void stage_scene(const float* __restrict__ sv_global, int n_sv, float* sv, float4* table,
                                            SceneView& s) {
  for (int i = threadIdx.x; i < n_sv; i += blockDim.x) sv[i] = sv_global[i];
  if constexpr (STAGED_TABLE<B>) {
    for (int i = threadIdx.x; i < s.n_tris; i += blockDim.x) stage_mesh_triangle(sv_global, s.topo, i, table);
    s.tris = table;
  }
  s.sv = sv;
}

// The records of samples [k0, k0 + samples) of pixels [p0, p0 + pixels):
// sample k's words at rec[k][bounce][word][pixel - p0], the bounces its
// path entered at lens[k][pixel - p0].
template <class B, bool MEDIA>
__global__ void __launch_bounds__(BWD_THREADS)
    record_kernel(const float* __restrict__ sv_global, int n_sv, const uint32_t* __restrict__ keys,
                  float* __restrict__ rec, int* __restrict__ lens, int width, int height, int depth, int flags,
                  int p0, int pixels, int k0, int samples, SceneView s) {
  extern __shared__ __align__(16) float smem[];
  float4* table = reinterpret_cast<float4*>(reinterpret_cast<char*>(smem) + align16(n_sv * sizeof(float)));
  stage_scene<B>(sv_global, n_sv, smem, table, s);
  __syncthreads();

  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= pixels) return;
  const int n = width * height;
  const size_t sample_words = (size_t)depth * Record<MEDIA>::WORDS * pixels;
  for (int k = 0; k < samples; ++k) {
    const uint32_t* kk = keys + 4 * (k0 + k);  // (kc0, kc1, kb0, kb1) of the sample
    const Record<MEDIA> r = {rec + k * sample_words + q, pixels};
    lens[(size_t)k * pixels + q] =
        record_sample<B, MEDIA>(s, p0 + q, n, width, height, depth, flags, kk[0], kk[1], kk[2], kk[3], r);
  }
}

// The adjoint of the same chunk from its records, into partial[block][P]
// (the chunk's first block is p0 / BWD_THREADS); a chunk of later samples
// (k0 > 0) adds to the earlier chunks' sums.
template <class B, bool MEDIA>
__global__ void __launch_bounds__(BWD_THREADS, BWD_MIN_BLOCKS)
    adjoint_kernel(const float* __restrict__ sv_global, int n_sv, const uint32_t* __restrict__ keys,
                   const float* __restrict__ ct, float* __restrict__ rec, const int* __restrict__ lens,
                   float* __restrict__ partial, int width, int height, int spp, int depth, int flags, int p0,
                   int pixels, int k0, int samples, SceneView s) {
  extern __shared__ __align__(16) float smem[];
  float* acc = smem + n_sv;  // [n_sv][ACC_STRIDE]: column threadIdx.x is this thread's gradient
  const size_t at = align16(n_sv * (1 + ACC_STRIDE) * sizeof(float));  // after the gradient table
  float4* table = reinterpret_cast<float4*>(reinterpret_cast<char*>(smem) + at);
  stage_scene<B>(sv_global, n_sv, smem, table, s);
  for (int j = 0; j < n_sv; ++j) acc[j * ACC_STRIDE + threadIdx.x] = 0.0f;
  __syncthreads();

  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q < pixels) {
    const int n = width * height, p = p0 + q;
    const GradSink g = {acc + threadIdx.x, ACC_STRIDE};
    const float4 c = reinterpret_cast<const float4*>(ct)[p];
    const V3 ct_rad = v3(c.x / (float)spp, c.y / (float)spp, c.z / (float)spp);
    const size_t sample_words = (size_t)depth * Record<MEDIA>::WORDS * pixels;
    for (int k = 0; k < samples; ++k) {
      const uint32_t* kk = keys + 4 * (k0 + k);
      const Record<MEDIA> r = {rec + k * sample_words + q, pixels};
      adjoint_sample<B, MEDIA>(s, p, n, width, height, flags, kk[0], kk[1], kk[2], kk[3], ct_rad, r,
                               lens[(size_t)k * pixels + q], g);
    }
  }
  __syncthreads();
  float* row = partial + (size_t)(p0 / BWD_THREADS + blockIdx.x) * n_sv;
  for (int j = threadIdx.x; j < n_sv; j += blockDim.x) {
    float sum = 0.0f;
    for (int t = 0; t < BWD_THREADS; ++t) sum += acc[j * ACC_STRIDE + t];
    row[j] = k0 == 0 ? sum : row[j] + sum;
  }
}

// out[j] = sum over blocks b of partial[b][j], in a fixed order.
__global__ void __launch_bounds__(REDUCE_THREADS)
    reduce_blocks_kernel(const float* __restrict__ partial, int num_blocks, int n_sv, float* __restrict__ out) {
  __shared__ double s[REDUCE_THREADS];
  const int j = blockIdx.x;
  double sum = 0.0;
  for (int b = threadIdx.x; b < num_blocks; b += REDUCE_THREADS) sum += partial[(size_t)b * n_sv + j];
  s[threadIdx.x] = sum;
  __syncthreads();
  for (int w = REDUCE_THREADS / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) s[threadIdx.x] += s[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[j] = (float)s[0];
}

// One chunk of record_plan: pixels [p0, p0 + pixels) (p0 a multiple of
// BWD_THREADS) and samples [k0, k0 + samples).
struct Chunk {
  int p0, pixels, k0, samples;
};

inline bool chunk_ok(const Chunk& c, int n, int spp) {
  return c.p0 >= 0 && c.p0 % BWD_THREADS == 0 && c.pixels > 0 && c.p0 + c.pixels <= n && c.k0 >= 0 &&
         c.samples > 0 && c.k0 + c.samples <= spp;
}

// One launch of record_kernel on `stream` for chunk `c` into rec, which
// holds record_bytes of the chunk (its lengths after its records). `s` is
// the scene's structure (its sv and triangle table are set to the block's
// copies in the kernel). Returns a cudaError_t (0 = success).
template <class B, bool MEDIA = false>
int launch_record(const float* sv, int n_sv, const uint32_t* keys, float* rec, int width, int height, int spp,
                  int depth, int flags, SceneView s, Chunk c, void* stream) {
  if (s.n_lights > REC_MAX_LIGHTS || !chunk_ok(c, width * height, spp)) return (int)cudaErrorInvalidValue;
  const size_t smem = record_smem_bytes(n_sv, s.n_tris);
  cudaError_t err = cudaFuncSetAttribute(record_kernel<B, MEDIA>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  int* lens = reinterpret_cast<int*>(rec + (size_t)c.samples * depth * Record<MEDIA>::WORDS * c.pixels);
  record_kernel<B, MEDIA><<<(c.pixels + BWD_THREADS - 1) / BWD_THREADS, BWD_THREADS, smem, (cudaStream_t)stream>>>(
      sv, n_sv, keys, rec, lens, width, height, depth, flags, c.p0, c.pixels, c.k0, c.samples, s);
  return (int)cudaGetLastError();
}

// One launch of adjoint_kernel on `stream` for chunk `c` from the records
// launch_record wrote into rec, into partial[ceil(W*H/THREADS)][n_sv] (the
// chunk's blocks; a chunk with k0 > 0 adds to them). Returns a cudaError_t.
template <class B, bool MEDIA = false>
int launch_adjoint(const float* sv, int n_sv, const uint32_t* keys, const float* ct, float* rec, float* partial,
                   int width, int height, int spp, int depth, int flags, SceneView s, Chunk c, void* stream) {
  if (s.n_lights > REC_MAX_LIGHTS || !chunk_ok(c, width * height, spp)) return (int)cudaErrorInvalidValue;
  const size_t smem = backward_smem_bytes(n_sv, s.n_tris);
  cudaError_t err = cudaFuncSetAttribute(adjoint_kernel<B, MEDIA>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int* lens = reinterpret_cast<const int*>(rec + (size_t)c.samples * depth * Record<MEDIA>::WORDS * c.pixels);
  adjoint_kernel<B, MEDIA><<<(c.pixels + BWD_THREADS - 1) / BWD_THREADS, BWD_THREADS, smem, (cudaStream_t)stream>>>(
      sv, n_sv, keys, ct, rec, lens, partial, width, height, spp, depth, flags, c.p0, c.pixels, c.k0, c.samples, s);
  return (int)cudaGetLastError();
}

// Each kernel's resources for a scene of n_sv scalars and n_tris triangles:
// out[0..3] the record kernel's registers, stack bytes a thread, dynamic
// shared bytes a block and blocks an SM (cudaOccupancyMaxActiveBlocksPer-
// Multiprocessor), out[4..7] the adjoint kernel's. Returns a cudaError_t.
template <class B, bool MEDIA = false>
int backward_resources(int n_sv, int n_tris, int* out) {
  const void* fns[2] = {(const void*)record_kernel<B, MEDIA>, (const void*)adjoint_kernel<B, MEDIA>};
  const size_t smem[2] = {record_smem_bytes(n_sv, n_tris), backward_smem_bytes(n_sv, n_tris)};
  for (int i = 0; i < 2; ++i) {
    cudaError_t err = cudaFuncSetAttribute(fns[i], cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem[i]);
    cudaFuncAttributes a;
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&a, fns[i]);
    if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out + 4 * i + 3, fns[i], BWD_THREADS,
                                                                                 smem[i]);
    if (err != cudaSuccess) return (int)err;
    out[4 * i] = a.numRegs;
    out[4 * i + 1] = (int)a.localSizeBytes;
    out[4 * i + 2] = (int)smem[i];
  }
  return 0;
}

// backward_resources of the backend named by `backend` (0 analytical, 2
// small mesh; 1, the SDF scene, is megakernel_sdf.cu's, built for its
// counts).
template <bool MEDIA>
int backward_resources_of(int backend, int n_sv, int n_tris, int* out) {
  switch (backend) {
    case 0: return backward_resources<AnalyticalAdj, MEDIA>(n_sv, n_tris, out);
    case 2: return backward_resources<MeshAdj, MEDIA>(n_sv, n_tris, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace pt
