// K2's MEDIA instantiations (megakernel_bwd.cuh's template with MEDIA on
// the analytical, SDF and mesh backends: the record kernel and the adjoint
// kernel), a library of their own because ops/_build.py
// compiles it without FMA contraction (-fmad=false), the record kernel as
// well as the adjoint, so that the records' carries round as the values
// the adjoint differentiates did. Inside a glass sphere at depth 6 a path
// meets walls near grazing and near the critical angle, where a
// refraction's or reflection's derivative grows as 1/|<rd, n>|;
// contracted, the adjoint's products round another way than the plain
// version's separate operations and such a pixel's gradient moves by up to
// 0.5% (tests/test_torch_k2_rounding.py --media: the host build with g++'s
// contraction sits 1.3e-2 off the plain version in the gate's relative
// measure, without it 2e-5 over every pixel). The media-free
// instantiations keep the default flags.

#include "megakernel_bwd.cuh"

// The media-free entry points' arguments, over 26-scalar material records
// (a scene whose material table declares a medium); the reduction is
// megakernel_bwd.cu's.
extern "C" int pt_render_backward_media_record(const float* sv, int n_sv, const uint32_t* keys, float* rec,
                                               int width, int height, int spp, int depth, int n_lights,
                                               int n_materials, int flags, int p0, int pixels, int k0, int samples,
                                               void* stream) {
  const pt::SceneView s = pt::analytical_view(nullptr, n_lights, n_materials, (flags & pt::FLAG_RESPECT_MAX_DIST) != 0);
  return pt::launch_record<pt::AnalyticalAdj, true>(sv, n_sv, keys, rec, width, height, spp, depth, flags, s,
                                                    {p0, pixels, k0, samples}, stream);
}

extern "C" int pt_render_backward_media_adjoint(const float* sv, int n_sv, const uint32_t* keys, const float* ct,
                                                float* rec, float* partial, int width, int height, int spp,
                                                int depth, int n_lights, int n_materials, int flags, int p0,
                                                int pixels, int k0, int samples, void* stream) {
  const pt::SceneView s = pt::analytical_view(nullptr, n_lights, n_materials, (flags & pt::FLAG_RESPECT_MAX_DIST) != 0);
  return pt::launch_adjoint<pt::AnalyticalAdj, true>(sv, n_sv, keys, ct, rec, partial, width, height, spp, depth,
                                                     flags, s, {p0, pixels, k0, samples}, stream);
}

extern "C" int pt_render_backward_media_sdf_record(const float* sv, int n_sv, const uint32_t* keys, float* rec,
                                                   int width, int height, int spp, int depth, int n_lights,
                                                   int n_materials, int flags, int n_spheres, int n_boxes,
                                                   int n_tori, int p0, int pixels, int k0, int samples,
                                                   void* stream) {
  if (n_spheres + n_boxes + n_tori + 1 > pt::SDF_MAX_PRIMS) return (int)cudaErrorInvalidValue;
  const pt::SceneView s = pt::sdf_view(nullptr, n_lights, n_materials, n_spheres, n_boxes, n_tori);
  return pt::launch_record<pt::SdfAdj, true>(sv, n_sv, keys, rec, width, height, spp, depth, flags, s,
                                             {p0, pixels, k0, samples}, stream);
}

extern "C" int pt_render_backward_media_sdf_adjoint(const float* sv, int n_sv, const uint32_t* keys, const float* ct,
                                                    float* rec, float* partial, int width, int height, int spp,
                                                    int depth, int n_lights, int n_materials, int flags,
                                                    int n_spheres, int n_boxes, int n_tori, int p0, int pixels,
                                                    int k0, int samples, void* stream) {
  if (n_spheres + n_boxes + n_tori + 1 > pt::SDF_MAX_PRIMS) return (int)cudaErrorInvalidValue;
  const pt::SceneView s = pt::sdf_view(nullptr, n_lights, n_materials, n_spheres, n_boxes, n_tori);
  return pt::launch_adjoint<pt::SdfAdj, true>(sv, n_sv, keys, ct, rec, partial, width, height, spp, depth, flags, s,
                                              {p0, pixels, k0, samples}, stream);
}

extern "C" int pt_render_backward_media_mesh_record(const float* sv, int n_sv, const uint32_t* keys, float* rec,
                                                    int width, int height, int spp, int depth, int n_lights,
                                                    int n_materials, int flags, const int* topo, int n_tris,
                                                    int n_verts, int p0, int pixels, int k0, int samples,
                                                    void* stream) {
  const pt::SceneView s = pt::mesh_view(nullptr, n_lights, n_materials, topo, n_tris, n_verts);
  return pt::launch_record<pt::MeshAdj, true>(sv, n_sv, keys, rec, width, height, spp, depth, flags, s,
                                              {p0, pixels, k0, samples}, stream);
}

extern "C" int pt_render_backward_media_mesh_adjoint(const float* sv, int n_sv, const uint32_t* keys,
                                                     const float* ct, float* rec, float* partial, int width,
                                                     int height, int spp, int depth, int n_lights, int n_materials,
                                                     int flags, const int* topo, int n_tris, int n_verts, int p0,
                                                     int pixels, int k0, int samples, void* stream) {
  const pt::SceneView s = pt::mesh_view(nullptr, n_lights, n_materials, topo, n_tris, n_verts);
  return pt::launch_adjoint<pt::MeshAdj, true>(sv, n_sv, keys, ct, rec, partial, width, height, spp, depth, flags, s,
                                               {p0, pixels, k0, samples}, stream);
}

// The MEDIA instantiations' resources, as megakernel_bwd.cu's.
extern "C" int pt_backward_resources(int backend, int n_sv, int n_tris, int* out) {
  return pt::backward_resources_of<true>(backend, n_sv, n_tris, out);
}

extern "C" const char* pt_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }
