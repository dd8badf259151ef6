// The SDF backend (K5) for one scene's primitive counts: K1's and K3's
// instantiations with and without the medium (megakernel_fwd.cuh), the
// march-step counter K6, and K2's media-free record and adjoint kernels
// (megakernel_bwd.cuh) with K5's adjoint (sdf_adj.cuh). K2's MEDIA ones are
// megakernel_sdf_bwd_media.cu, built apart without FMA contraction as
// megakernel_bwd_media.cu is. megakernel_sdf.cuh says how the counts come
// in. The entry points are those the other libraries had when the counts
// were read at run time, with the same arguments.
//
// K6 replaces the TPU kernel pathtracer_tpu/ops/megakernel_sdf.py::
// measure_march_steps, which reports per tile of 1024 lanes the march trips
// the whole tile ran (its slowest lane, rounded up to a block of 12), for
// the primary march and the NEE shadow march. Here one thread per pixel
// writes its own two counts (sdf.cuh march_steps_pixel: center ray, no
// random numbers); ops/megakernel_sdf.measure_march_steps reduces them per
// warp of 32, the unit that runs in lock step on this card, as the TPU
// kernel's tile envelope. What bounds it: the march itself, like K1 on the
// SDF scene. Each thread reads the packed scene (shared memory per block)
// and writes 8 bytes; a warp runs until its slowest lane's march is done.

#include "megakernel_fwd.cuh"
#include "megakernel_sdf.cuh"

namespace pt {

constexpr int MARCH_THREADS = 128;

__global__ void __launch_bounds__(MARCH_THREADS)
    march_steps_kernel(const float* __restrict__ sv_global, int n_sv, int* __restrict__ steps,
                       int* __restrict__ shadow_steps, int width, int height, SceneView s) {
  extern __shared__ __align__(16) float sv[];
  for (int i = threadIdx.x; i < n_sv; i += blockDim.x) sv[i] = sv_global[i];
  __syncthreads();

  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= width * height) return;
  s.sv = sv;
  march_steps_pixel<SceneCounts>(s, p, width, height, steps[p], shadow_steps[p]);
}

template <bool MEDIA>
int launch_sdf(const float* sv, int n_sv, const uint32_t* keys, float* out, int* entered, int width, int height,
               int spp, int depth, int n_lights, int n_materials, int flags, int n_spheres, int n_boxes, int n_tori,
               void* stream) {
  const SceneView s = sdf_view(nullptr, n_lights, n_materials, n_spheres, n_boxes, n_tori);
  return sdf_launch(n_spheres, n_boxes, n_tori, [&] {
    return launch_forward<SdfScene, MEDIA>(sv, n_sv, keys, out, entered, width, height, spp, depth, flags, s, stream);
  });
}

}  // namespace pt

// K3's entry points (K1's with a null `entered`): one frame of the SDF
// scene, and the bounces each sample's path entered alive written to
// `entered` (int32 [spp, H, W]). 0 = success, else a cudaError_t.
extern "C" int pt_render_forward_occupancy_sdf(const float* sv, int n_sv, const uint32_t* keys, float* out,
                                               int* entered, int width, int height, int spp, int depth, int n_lights,
                                               int n_materials, int flags, int n_spheres, int n_boxes, int n_tori,
                                               void* stream) {
  return pt::launch_sdf<false>(sv, n_sv, keys, out, entered, width, height, spp, depth, n_lights, n_materials, flags,
                               n_spheres, n_boxes, n_tori, stream);
}

extern "C" int pt_render_forward_sdf(const float* sv, int n_sv, const uint32_t* keys, float* out, int width,
                                     int height, int spp, int depth, int n_lights, int n_materials, int flags,
                                     int n_spheres, int n_boxes, int n_tori, void* stream) {
  return pt::launch_sdf<false>(sv, n_sv, keys, out, nullptr, width, height, spp, depth, n_lights, n_materials, flags,
                               n_spheres, n_boxes, n_tori, stream);
}

// The media instantiation's: the same arguments over a packed vector whose
// material records hold 26 scalars.
extern "C" int pt_render_forward_occupancy_media_sdf(const float* sv, int n_sv, const uint32_t* keys, float* out,
                                                     int* entered, int width, int height, int spp, int depth,
                                                     int n_lights, int n_materials, int flags, int n_spheres,
                                                     int n_boxes, int n_tori, void* stream) {
  return pt::launch_sdf<true>(sv, n_sv, keys, out, entered, width, height, spp, depth, n_lights, n_materials, flags,
                              n_spheres, n_boxes, n_tori, stream);
}

extern "C" int pt_render_forward_media_sdf(const float* sv, int n_sv, const uint32_t* keys, float* out, int width,
                                           int height, int spp, int depth, int n_lights, int n_materials, int flags,
                                           int n_spheres, int n_boxes, int n_tori, void* stream) {
  return pt::launch_sdf<true>(sv, n_sv, keys, out, nullptr, width, height, spp, depth, n_lights, n_materials, flags,
                              n_spheres, n_boxes, n_tori, stream);
}

// K1's and K3's layout (megakernel_fwd.cu's pt_forward_layout) for backend
// 1, the SDF scene.
extern "C" int pt_forward_layout(int backend, int media, int n_sv, int n_tris, long long* out) {
  if (backend != 1) return (int)cudaErrorInvalidValue;
  media ? pt::forward_layout<pt::SdfScene, true>(n_sv, n_tris, out)
        : pt::forward_layout<pt::SdfScene, false>(n_sv, n_tris, out);
  return 0;
}

// K6: writes steps[p] and shadow_steps[p] for every pixel of the SDF scene
// on `stream`; returns a cudaError_t (0 = success).
extern "C" int pt_march_steps(const float* sv, int n_sv, int* steps, int* shadow_steps, int width, int height,
                              int n_lights, int n_materials, int n_spheres, int n_boxes, int n_tori, void* stream) {
  const pt::SceneView s = pt::sdf_view(nullptr, n_lights, n_materials, n_spheres, n_boxes, n_tori);
  const int blocks = (width * height + pt::MARCH_THREADS - 1) / pt::MARCH_THREADS;
  return pt::sdf_launch(n_spheres, n_boxes, n_tori, [&] {
    pt::march_steps_kernel<<<blocks, pt::MARCH_THREADS, n_sv * sizeof(float), (cudaStream_t)stream>>>(
        sv, n_sv, steps, shadow_steps, width, height, s);
    return (int)cudaGetLastError();
  });
}

// K2's record and adjoint kernels for one chunk (megakernel_bwd.cu's
// entry points; more than pt_backward_sdf_max_primitives() primitives, the
// plane included, is cudaErrorInvalidValue).
extern "C" int pt_render_backward_sdf_record(const float* sv, int n_sv, const uint32_t* keys, float* rec, int width,
                                             int height, int spp, int depth, int n_lights, int n_materials,
                                             int flags, int n_spheres, int n_boxes, int n_tori, int p0, int pixels,
                                             int k0, int samples, void* stream) {
  if (pt::SceneCounts::PRIMS > pt::SDF_MAX_PRIMS) return (int)cudaErrorInvalidValue;
  const pt::SceneView s = pt::sdf_view(nullptr, n_lights, n_materials, n_spheres, n_boxes, n_tori);
  return pt::sdf_launch(n_spheres, n_boxes, n_tori, [&] {
    return pt::launch_record<pt::SdfSceneAdj>(sv, n_sv, keys, rec, width, height, spp, depth, flags, s,
                                              {p0, pixels, k0, samples}, stream);
  });
}

extern "C" int pt_render_backward_sdf_adjoint(const float* sv, int n_sv, const uint32_t* keys, const float* ct,
                                              float* rec, float* partial, int width, int height, int spp, int depth,
                                              int n_lights, int n_materials, int flags, int n_spheres, int n_boxes,
                                              int n_tori, int p0, int pixels, int k0, int samples, void* stream) {
  if (pt::SceneCounts::PRIMS > pt::SDF_MAX_PRIMS) return (int)cudaErrorInvalidValue;
  const pt::SceneView s = pt::sdf_view(nullptr, n_lights, n_materials, n_spheres, n_boxes, n_tori);
  return pt::sdf_launch(n_spheres, n_boxes, n_tori, [&] {
    return pt::launch_adjoint<pt::SdfSceneAdj>(sv, n_sv, keys, ct, rec, partial, width, height, spp, depth, flags, s,
                                               {p0, pixels, k0, samples}, stream);
  });
}

// K2's kernels' resources (megakernel_bwd.cu's pt_backward_resources) for
// backend 1, the SDF scene.
extern "C" int pt_backward_resources(int backend, int n_sv, int n_tris, int* out) {
  if (backend != 1) return (int)cudaErrorInvalidValue;
  return pt::backward_resources<pt::SdfSceneAdj>(n_sv, n_tris, out);
}
