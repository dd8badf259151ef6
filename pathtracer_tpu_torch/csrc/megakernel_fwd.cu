// Forward path-tracing megakernel for the analytical scene on Hopper.
//
// Replaces the TPU kernel pathtracer_tpu/ops/megakernel.py::_pallas_forward
// (body _make_kernel -> _trace_tile -> _tile_bounce, analytical backend).
// It computes what integrator/tracer.render_frame computes for one frame:
// one thread per pixel loops over the spp samples and, per sample, runs the
// camera ray and up to `depth` bounces of closest hit, emitter pass with
// MIS, background, alpha pass-through, NEE with a shadow ray and the
// four-lobe Disney sample, then writes the mean over samples into the
// [H, W, 4] frame (alpha 1).
//
// Random numbers are threefry2x32 drawn in the kernel at the same flat
// counters as ops/rng: camera uniform j of pixel p is uniform(kc)[p*2 + j],
// bounce uniform j at depth d is uniform(kb)[(d*N + p)*8 + j], N = W*H,
// with (kc, kb) = split(k_s) of each sample's key, precomputed on the host.
// A thread leaves the bounce loop once its path is dead; the Python code
// freezes dead lanes instead, and counter-based draws make the two equal.
//
// What bounds it on this card: arithmetic and divergence. Each ray reads
// the 112-float packed scene (copied to shared memory per block) and
// writes 16 bytes; everything else is per-thread math with data-dependent
// branches (lobe choice, misses, early exits). This first version does
// nothing about that beyond __launch_bounds__.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tracer.cuh"

namespace pt {

constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS)
    render_forward_kernel(const float* __restrict__ sv_global, int n_sv, const uint32_t* __restrict__ keys,
                          float* __restrict__ out, int width, int height, float inv_w, float inv_h, int spp,
                          int depth, int n_lights, int n_materials, int flags) {
  extern __shared__ float sv[];
  for (int i = threadIdx.x; i < n_sv; i += blockDim.x) sv[i] = sv_global[i];
  __syncthreads();

  const int n = width * height;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;

  const SceneView s = {sv, n_lights, n_materials, (flags & FLAG_RESPECT_MAX_DIST) != 0};
  V3 sum = splat3(0.0f);
  for (int k = 0; k < spp; ++k) {
    const uint32_t* kk = keys + 4 * k;  // (kc0, kc1, kb0, kb1) of sample k
    V3 r = trace_sample(s, p, n, width, height, inv_w, inv_h, depth, flags, kk[0], kk[1], kk[2], kk[3]);
    sum = k == 0 ? r : sum + r;
  }
  if (spp > 1) sum = sum / (float)spp;
  float4* o = reinterpret_cast<float4*>(out) + p;
  *o = make_float4(sum.x, sum.y, sum.z, 1.0f);
}

}  // namespace pt

// Launches one frame on `stream`; returns cudaGetLastError() (0 = success).
extern "C" int pt_render_forward(const float* sv, int n_sv, const uint32_t* keys, float* out, int width,
                                 int height, float inv_w, float inv_h, int spp, int depth, int n_lights,
                                 int n_materials, int flags, void* stream) {
  const int n = width * height;
  const int blocks = (n + pt::THREADS - 1) / pt::THREADS;
  pt::render_forward_kernel<<<blocks, pt::THREADS, n_sv * sizeof(float), (cudaStream_t)stream>>>(
      sv, n_sv, keys, out, width, height, inv_w, inv_h, spp, depth, n_lights, n_materials, flags);
  return (int)cudaGetLastError();
}

extern "C" const char* pt_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }
