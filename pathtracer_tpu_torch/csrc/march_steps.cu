// March-step counter (K6) of the SDF scene on Hopper.
//
// Replaces the TPU kernel pathtracer_tpu/ops/megakernel_sdf.py::
// measure_march_steps, which reports per tile of 1024 lanes the march trips
// the whole tile ran (its slowest lane, rounded up to a block of 12), for
// the primary march and the NEE shadow march. Here one thread per pixel
// writes its own two counts (sdf.cuh march_steps_pixel: center ray, no
// random numbers); ops/megakernel_sdf.measure_march_steps reduces them per
// warp of 32, the unit that runs in lock step on this card, as the TPU
// kernel's tile envelope.
//
// What bounds it: the march itself, like K1 on the SDF scene. Each thread
// reads the packed scene (shared memory per block) and writes 8 bytes; a
// warp runs until its slowest lane's march is done.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sdf.cuh"

namespace pt {

constexpr int MARCH_THREADS = 128;

__global__ void __launch_bounds__(MARCH_THREADS)
    march_steps_kernel(const float* __restrict__ sv_global, int n_sv, int* __restrict__ steps,
                       int* __restrict__ shadow_steps, int width, int height, SceneView s) {
  extern __shared__ float sv[];
  for (int i = threadIdx.x; i < n_sv; i += blockDim.x) sv[i] = sv_global[i];
  __syncthreads();

  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= width * height) return;
  s.sv = sv;
  march_steps_pixel(s, p, width, height, steps[p], shadow_steps[p]);
}

}  // namespace pt

// Writes steps[p] and shadow_steps[p] for every pixel of the SDF scene on
// `stream`; returns cudaGetLastError() (0 = success).
extern "C" int pt_march_steps(const float* sv, int n_sv, int* steps, int* shadow_steps, int width, int height,
                              int n_lights, int n_materials, int n_spheres, int n_boxes, int n_tori, void* stream) {
  const pt::SceneView s = pt::sdf_view(nullptr, n_lights, n_materials, n_spheres, n_boxes, n_tori);
  const int n = width * height;
  const int blocks = (n + pt::MARCH_THREADS - 1) / pt::MARCH_THREADS;
  pt::march_steps_kernel<<<blocks, pt::MARCH_THREADS, n_sv * sizeof(float), (cudaStream_t)stream>>>(
      sv, n_sv, steps, shadow_steps, width, height, s);
  return (int)cudaGetLastError();
}

extern "C" const char* pt_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }
