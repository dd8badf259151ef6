// K2's MEDIA instantiation on the SDF backend for one scene's primitive
// counts (megakernel_sdf.cuh): its record and adjoint kernels, built
// without FMA contraction (-fmad=false) as megakernel_bwd_media.cu's other
// MEDIA instantiations are, for the same reason.

#include "megakernel_sdf.cuh"

extern "C" int pt_render_backward_media_sdf_record(const float* sv, int n_sv, const uint32_t* keys, float* rec,
                                                   int width, int height, int spp, int depth, int n_lights,
                                                   int n_materials, int flags, int n_spheres, int n_boxes,
                                                   int n_tori, int p0, int pixels, int k0, int samples,
                                                   void* stream) {
  if (pt::SceneCounts::PRIMS > pt::SDF_MAX_PRIMS) return (int)cudaErrorInvalidValue;
  const pt::SceneView s = pt::sdf_view(nullptr, n_lights, n_materials, n_spheres, n_boxes, n_tori);
  return pt::sdf_launch(n_spheres, n_boxes, n_tori, [&] {
    return pt::launch_record<pt::SdfSceneAdj, true>(sv, n_sv, keys, rec, width, height, spp, depth, flags, s,
                                                    {p0, pixels, k0, samples}, stream);
  });
}

extern "C" int pt_render_backward_media_sdf_adjoint(const float* sv, int n_sv, const uint32_t* keys, const float* ct,
                                                    float* rec, float* partial, int width, int height, int spp,
                                                    int depth, int n_lights, int n_materials, int flags,
                                                    int n_spheres, int n_boxes, int n_tori, int p0, int pixels,
                                                    int k0, int samples, void* stream) {
  if (pt::SceneCounts::PRIMS > pt::SDF_MAX_PRIMS) return (int)cudaErrorInvalidValue;
  const pt::SceneView s = pt::sdf_view(nullptr, n_lights, n_materials, n_spheres, n_boxes, n_tori);
  return pt::sdf_launch(n_spheres, n_boxes, n_tori, [&] {
    return pt::launch_adjoint<pt::SdfSceneAdj, true>(sv, n_sv, keys, ct, rec, partial, width, height, spp, depth,
                                                     flags, s, {p0, pixels, k0, samples}, stream);
  });
}

// The MEDIA instantiation's resources, as megakernel_sdf.cu's.
extern "C" int pt_backward_resources(int backend, int n_sv, int n_tris, int* out) {
  if (backend != 1) return (int)cudaErrorInvalidValue;
  return pt::backward_resources<pt::SdfSceneAdj, true>(n_sv, n_tris, out);
}
