// Backward path-tracing megakernel (K2) on Hopper, generic over the scene
// backend as K1 is: the analytical scene (analytical_adj.cuh), the
// sphere-traced SDF scene (sdf_adj.cuh, the adjoint of K5) and the small
// triangle mesh (mesh_adj.cuh, the adjoint of K7). The big mesh (K8) has
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
// the per-thread adjoint.
//
// One thread per pixel loops over the spp samples. Each sample replays the
// path with K1's in-kernel threefry counters (the same numbers for the same
// keys), storing the carry that enters each bounce (14 floats per bounce in
// local memory, 20 with the medium in the MEDIA instantiation, depth <=
// MAX_DEPTH), then walks the bounces in reverse. The
// cotangent is grad_out[..., :3] / spp; the alpha channel gets none.
//
// Reduction: each thread adds into its own column of a [P][THREADS+1]
// shared-memory table (padded against bank conflicts), so no atomics; the
// small mesh's [T, 4] topology follows the table (75,720 bytes a block for
// the demo mesh, P = 145, over 48 KB: the launch opts in to more); the
// block then sums each row in thread order into partial[block][P], and a
// second kernel sums the blocks of each entry in a fixed order (in double).
// The gradient is the same bit for bit from run to run.
//
// What bounds it on this card: arithmetic, divergence and register
// pressure. The adjoint of a bounce re-runs its forward and then several
// hundred more flops per lane with data-dependent branches; the stored
// carries live in a per-thread stack frame in local memory and the live
// state needs about twice K1's registers (ptxas -v prints both). With the
// SDF backend each bounce's closest hit and shadow ray are marched twice,
// in the forward sweep and in the re-run, K1's march each time, and each
// hit adds the SDF adjoint's two forward-mode passes over the primitives.
// With the mesh backend each closest hit tests every triangle three times
// (the forward sweep, the re-run and the adjoint's winner search).
// This first version does nothing about that beyond __launch_bounds__.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "analytical_adj.cuh"
#include "mesh_adj.cuh"
#include "sdf_adj.cuh"
#include "tracer_adj.cuh"

namespace pt {

constexpr int BWD_THREADS = 128;
constexpr int ACC_STRIDE = BWD_THREADS + 1;
constexpr int REDUCE_THREADS = 256;
// Whether K2 copies the backend's topology to shared memory (mesh_adj.cuh),
// as K1 does for Mesh: the other instantiations compile no copy.
template <class B>
constexpr bool SHARED_TOPOLOGY = std::is_same_v<B, MeshAdj>;

// Dynamic shared memory of one block: the packed vector, the gradient table
// and the topology of n_tris triangles.
inline size_t backward_smem_bytes(int n_sv, int n_tris) {
  return (size_t)n_sv * (1 + ACC_STRIDE) * sizeof(float) + 4 * (size_t)n_tris * sizeof(int);
}

template <class B, bool MEDIA = false>
__global__ void __launch_bounds__(BWD_THREADS)
    render_backward_kernel(const float* __restrict__ sv_global, int n_sv, const uint32_t* __restrict__ keys,
                           const float* __restrict__ ct, float* __restrict__ partial, int width, int height,
                           int spp, int depth, int flags, SceneView s) {
  extern __shared__ float smem[];
  float* sv = smem;           // [n_sv] packed scene
  float* acc = smem + n_sv;   // [n_sv][ACC_STRIDE]: column threadIdx.x is this thread's gradient
  int* topo = reinterpret_cast<int*>(acc + n_sv * ACC_STRIDE);  // [n_tris][4]
  for (int i = threadIdx.x; i < n_sv; i += blockDim.x) sv[i] = sv_global[i];
  if constexpr (SHARED_TOPOLOGY<B>) {
    for (int i = threadIdx.x; i < 4 * s.n_tris; i += blockDim.x) topo[i] = s.topo[i];
  }
  for (int j = 0; j < n_sv; ++j) acc[j * ACC_STRIDE + threadIdx.x] = 0.0f;
  __syncthreads();

  const int n = width * height;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p < n) {
    s.sv = sv;
    if constexpr (SHARED_TOPOLOGY<B>) s.topo = topo;
    const GradSink g = {acc + threadIdx.x, ACC_STRIDE};
    const float4 c = reinterpret_cast<const float4*>(ct)[p];
    const V3 ct_rad = v3(c.x / (float)spp, c.y / (float)spp, c.z / (float)spp);
    for (int k = 0; k < spp; ++k) {
      const uint32_t* kk = keys + 4 * k;  // (kc0, kc1, kb0, kb1) of sample k
      trace_sample_adj<B, MEDIA>(s, p, n, width, height, depth, flags, kk[0], kk[1], kk[2], kk[3], ct_rad, g);
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < n_sv; j += blockDim.x) {
    float sum = 0.0f;
    for (int t = 0; t < BWD_THREADS; ++t) sum += acc[j * ACC_STRIDE + t];
    partial[(size_t)blockIdx.x * n_sv + j] = sum;
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

// d(<ct, frame>)/d(sv) into grad[n_sv], using partial[ceil(W*H/THREADS)][n_sv]
// as scratch, on `stream`; `s` is the scene's structure (its sv is set to
// the shared copies in the kernel). Returns a cudaError_t (0 = success).
template <class B, bool MEDIA = false>
int launch_backward(const float* sv, int n_sv, const uint32_t* keys, const float* ct, float* partial, float* grad,
                    int width, int height, int spp, int depth, int flags, SceneView s, void* stream) {
  if (depth > MAX_DEPTH) return (int)cudaErrorInvalidValue;
  const int n = width * height;
  const int blocks = (n + BWD_THREADS - 1) / BWD_THREADS;
  const size_t smem = backward_smem_bytes(n_sv, s.n_tris);
  cudaError_t err = cudaFuncSetAttribute(render_backward_kernel<B, MEDIA>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  render_backward_kernel<B, MEDIA><<<blocks, BWD_THREADS, smem, (cudaStream_t)stream>>>(
      sv, n_sv, keys, ct, partial, width, height, spp, depth, flags, s);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_blocks_kernel<<<n_sv, REDUCE_THREADS, 0, (cudaStream_t)stream>>>(partial, blocks, n_sv, grad);
  return (int)cudaGetLastError();
}

}  // namespace pt
