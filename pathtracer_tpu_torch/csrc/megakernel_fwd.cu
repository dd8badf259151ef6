// Forward path-tracing megakernel (K1) on Hopper, generic over the scene
// backend: the analytical scene (analytical.cuh) and the sphere-traced SDF
// scene (sdf.cuh, the port of the SDF backend K5).
//
// Replaces the TPU kernel pathtracer_tpu/ops/megakernel.py::_pallas_forward
// (body _make_kernel -> _trace_tile -> _tile_bounce, over a KernelBackend).
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
// the packed scene (112 floats for the analytical demo, 140 for the SDF
// one; copied to shared memory per block) and writes 16 bytes; everything
// else is per-thread math with data-dependent branches (lobe choice,
// misses, early exits). On the SDF scene the march dominates: up to 96
// distance evaluations per ray, and a warp runs until its slowest lane's
// march is done (grazing rays that never converge take all 96). This first
// version does nothing about either beyond __launch_bounds__.

#include <cuda_runtime.h>
#include <stdint.h>

#include "analytical.cuh"
#include "sdf.cuh"
#include "tracer.cuh"

namespace pt {

constexpr int THREADS = 128;

template <class B>
__global__ void __launch_bounds__(THREADS)
    render_forward_kernel(const float* __restrict__ sv_global, int n_sv, const uint32_t* __restrict__ keys,
                          float* __restrict__ out, int width, int height, int spp, int depth, int flags,
                          SceneView s) {
  extern __shared__ float sv[];
  for (int i = threadIdx.x; i < n_sv; i += blockDim.x) sv[i] = sv_global[i];
  __syncthreads();

  const int n = width * height;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;

  s.sv = sv;
  V3 sum = splat3(0.0f);
  for (int k = 0; k < spp; ++k) {
    const uint32_t* kk = keys + 4 * k;  // (kc0, kc1, kb0, kb1) of sample k
    V3 r = trace_sample<B>(s, p, n, width, height, depth, flags, kk[0], kk[1], kk[2], kk[3]);
    sum = k == 0 ? r : sum + r;
  }
  if (spp > 1) sum = sum / (float)spp;
  float4* o = reinterpret_cast<float4*>(out) + p;
  *o = make_float4(sum.x, sum.y, sum.z, 1.0f);
}

// Launches one frame on `stream`; `s` is the scene's structure (its sv is
// set to the shared copy in the kernel). Returns cudaGetLastError().
template <class B>
int launch_forward(const float* sv, int n_sv, const uint32_t* keys, float* out, int width, int height, int spp,
                   int depth, int flags, SceneView s, void* stream) {
  const int n = width * height;
  const int blocks = (n + THREADS - 1) / THREADS;
  render_forward_kernel<B><<<blocks, THREADS, n_sv * sizeof(float), (cudaStream_t)stream>>>(
      sv, n_sv, keys, out, width, height, spp, depth, flags, s);
  return (int)cudaGetLastError();
}

}  // namespace pt

// One frame of the analytical scene (0 = success, else a cudaError_t).
extern "C" int pt_render_forward(const float* sv, int n_sv, const uint32_t* keys, float* out, int width,
                                 int height, int spp, int depth, int n_lights,
                                 int n_materials, int flags, void* stream) {
  const pt::SceneView s = pt::analytical_view(nullptr, n_lights, n_materials, (flags & pt::FLAG_RESPECT_MAX_DIST) != 0);
  return pt::launch_forward<pt::Analytical>(sv, n_sv, keys, out, width, height, spp, depth, flags, s, stream);
}

// One frame of the SDF scene with its primitive counts (0 = success).
extern "C" int pt_render_forward_sdf(const float* sv, int n_sv, const uint32_t* keys, float* out, int width,
                                     int height, int spp, int depth, int n_lights, int n_materials, int flags,
                                     int n_spheres, int n_boxes, int n_tori, void* stream) {
  const pt::SceneView s = pt::sdf_view(nullptr, n_lights, n_materials, n_spheres, n_boxes, n_tori);
  return pt::launch_forward<pt::Sdf>(sv, n_sv, keys, out, width, height, spp, depth, flags, s, stream);
}

extern "C" const char* pt_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }
