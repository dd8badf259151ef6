// K2's media-free entry points (the analytical, SDF and mesh instantiations
// of megakernel_bwd.cuh's template) and its helpers. The MEDIA
// instantiations are megakernel_bwd_media.cu, a library of their own.

#include "megakernel_bwd.cuh"

extern "C" int pt_backward_threads() { return pt::BWD_THREADS; }
extern "C" int pt_backward_max_depth() { return pt::MAX_DEPTH; }
extern "C" int pt_backward_sdf_max_primitives() { return pt::SDF_MAX_PRIMS; }

// Dynamic shared memory the backward kernel needs for n_sv scene scalars
// and a topology of n_tris triangles (0 but for the small mesh).
extern "C" size_t pt_backward_smem_bytes(int n_sv, int n_tris) { return pt::backward_smem_bytes(n_sv, n_tris); }

// The gradient of one frame of the analytical scene (0 = success, else a
// cudaError_t).
extern "C" int pt_render_backward(const float* sv, int n_sv, const uint32_t* keys, const float* ct, float* partial,
                                  float* grad, int width, int height, int spp, int depth,
                                  int n_lights, int n_materials, int flags, void* stream) {
  const pt::SceneView s = pt::analytical_view(nullptr, n_lights, n_materials, (flags & pt::FLAG_RESPECT_MAX_DIST) != 0);
  return pt::launch_backward<pt::AnalyticalAdj>(sv, n_sv, keys, ct, partial, grad, width, height, spp, depth, flags,
                                                s, stream);
}

// The gradient of one frame of the SDF scene with its primitive counts
// (0 = success; more than pt_backward_sdf_max_primitives() primitives,
// the plane included, is cudaErrorInvalidValue).
extern "C" int pt_render_backward_sdf(const float* sv, int n_sv, const uint32_t* keys, const float* ct,
                                      float* partial, float* grad, int width, int height, int spp, int depth,
                                      int n_lights, int n_materials, int flags, int n_spheres, int n_boxes,
                                      int n_tori, void* stream) {
  if (n_spheres + n_boxes + n_tori + 1 > pt::SDF_MAX_PRIMS) return (int)cudaErrorInvalidValue;
  const pt::SceneView s = pt::sdf_view(nullptr, n_lights, n_materials, n_spheres, n_boxes, n_tori);
  return pt::launch_backward<pt::SdfAdj>(sv, n_sv, keys, ct, partial, grad, width, height, spp, depth, flags, s,
                                         stream);
}

// The gradient of one frame of the small mesh scene with its topology
// [n_tris, 4] int32 (a, b, c, material) on the card (0 = success).
extern "C" int pt_render_backward_mesh(const float* sv, int n_sv, const uint32_t* keys, const float* ct,
                                       float* partial, float* grad, int width, int height, int spp, int depth,
                                       int n_lights, int n_materials, int flags, const int* topo, int n_tris,
                                       int n_verts, void* stream) {
  const pt::SceneView s = pt::mesh_view(nullptr, n_lights, n_materials, topo, n_tris, n_verts);
  return pt::launch_backward<pt::MeshAdj>(sv, n_sv, keys, ct, partial, grad, width, height, spp, depth, flags, s,
                                          stream);
}

extern "C" const char* pt_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }
