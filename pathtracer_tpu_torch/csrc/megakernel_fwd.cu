// K1's and K3's entry points for the analytical, small mesh and big mesh
// backends, with and without the medium (megakernel_fwd.cuh holds the
// template, its design and what bounds it). The SDF backend's are
// megakernel_sdf.cu's, a library built for each scene's primitive counts.

#include "megakernel_fwd.cuh"

// K3's entry points, one per backend: one frame, and the bounces each
// sample's path entered alive written to `entered` (int32 [spp, H, W]); with a
// null `entered` the launch is K1's. 0 = success, else a cudaError_t.
extern "C" int pt_render_forward_occupancy(const float* sv, int n_sv, const uint32_t* keys, float* out, int* entered,
                                           int width, int height, int spp, int depth, int n_lights, int n_materials,
                                           int flags, void* stream) {
  const pt::SceneView s = pt::analytical_view(nullptr, n_lights, n_materials, (flags & pt::FLAG_RESPECT_MAX_DIST) != 0);
  return pt::launch_forward<pt::Analytical>(sv, n_sv, keys, out, entered, width, height, spp, depth, flags, s, stream);
}

// The small mesh scene with its topology [n_tris, 4] int32 (a, b, c,
// material) on the card.
extern "C" int pt_render_forward_occupancy_mesh(const float* sv, int n_sv, const uint32_t* keys, float* out,
                                                int* entered, int width, int height, int spp, int depth,
                                                int n_lights, int n_materials, int flags, const int* topo, int n_tris,
                                                int n_verts, void* stream) {
  const pt::SceneView s = pt::mesh_view(nullptr, n_lights, n_materials, topo, n_tris, n_verts);
  return pt::launch_forward<pt::Mesh>(sv, n_sv, keys, out, entered, width, height, spp, depth, flags, s, stream);
}

// The big mesh scene with its tables on the card: coef [n_chunks * 128, 16],
// attr [8, n_chunks * 128], aabb [n_chunks, 8], float32.
extern "C" int pt_render_forward_occupancy_bigmesh(const float* sv, int n_sv, const uint32_t* keys, float* out,
                                                   int* entered, int width, int height, int spp, int depth,
                                                   int n_lights, int n_materials, int flags, const float* coef,
                                                   const float* attr, const float* aabb, int n_chunks, void* stream) {
  const pt::SceneView s = pt::bigmesh_view(nullptr, n_lights, n_materials, coef, attr, aabb, n_chunks);
  return pt::launch_forward<pt::BigMesh>(sv, n_sv, keys, out, entered, width, height, spp, depth, flags, s, stream);
}

// K1's entry points: K3's arguments without `entered`.
extern "C" int pt_render_forward(const float* sv, int n_sv, const uint32_t* keys, float* out, int width, int height,
                                 int spp, int depth, int n_lights, int n_materials, int flags, void* stream) {
  return pt_render_forward_occupancy(sv, n_sv, keys, out, nullptr, width, height, spp, depth, n_lights, n_materials,
                                     flags, stream);
}

extern "C" int pt_render_forward_mesh(const float* sv, int n_sv, const uint32_t* keys, float* out, int width,
                                      int height, int spp, int depth, int n_lights, int n_materials, int flags,
                                      const int* topo, int n_tris, int n_verts, void* stream) {
  return pt_render_forward_occupancy_mesh(sv, n_sv, keys, out, nullptr, width, height, spp, depth, n_lights,
                                          n_materials, flags, topo, n_tris, n_verts, stream);
}

extern "C" int pt_render_forward_bigmesh(const float* sv, int n_sv, const uint32_t* keys, float* out, int width,
                                         int height, int spp, int depth, int n_lights, int n_materials, int flags,
                                         const float* coef, const float* attr, const float* aabb, int n_chunks,
                                         void* stream) {
  return pt_render_forward_occupancy_bigmesh(sv, n_sv, keys, out, nullptr, width, height, spp, depth, n_lights,
                                             n_materials, flags, coef, attr, aabb, n_chunks, stream);
}

// The media instantiation's entry points, K3's and K1's for each backend:
// the same arguments as the media-free ones, over a packed vector whose
// material records hold 26 scalars.
extern "C" int pt_render_forward_occupancy_media(const float* sv, int n_sv, const uint32_t* keys, float* out,
                                                 int* entered, int width, int height, int spp, int depth, int n_lights,
                                                 int n_materials, int flags, void* stream) {
  const pt::SceneView s = pt::analytical_view(nullptr, n_lights, n_materials, (flags & pt::FLAG_RESPECT_MAX_DIST) != 0);
  return pt::launch_forward<pt::Analytical, true>(sv, n_sv, keys, out, entered, width, height, spp, depth, flags, s,
                                                  stream);
}

extern "C" int pt_render_forward_occupancy_media_mesh(const float* sv, int n_sv, const uint32_t* keys, float* out,
                                                      int* entered, int width, int height, int spp, int depth,
                                                      int n_lights, int n_materials, int flags, const int* topo,
                                                      int n_tris, int n_verts, void* stream) {
  const pt::SceneView s = pt::mesh_view(nullptr, n_lights, n_materials, topo, n_tris, n_verts);
  return pt::launch_forward<pt::Mesh, true>(sv, n_sv, keys, out, entered, width, height, spp, depth, flags, s, stream);
}

extern "C" int pt_render_forward_occupancy_media_bigmesh(const float* sv, int n_sv, const uint32_t* keys, float* out,
                                                         int* entered, int width, int height, int spp, int depth,
                                                         int n_lights, int n_materials, int flags, const float* coef,
                                                         const float* attr, const float* aabb, int n_chunks,
                                                         void* stream) {
  const pt::SceneView s = pt::bigmesh_view(nullptr, n_lights, n_materials, coef, attr, aabb, n_chunks);
  return pt::launch_forward<pt::BigMesh, true>(sv, n_sv, keys, out, entered, width, height, spp, depth, flags, s,
                                               stream);
}

extern "C" int pt_render_forward_media(const float* sv, int n_sv, const uint32_t* keys, float* out, int width,
                                       int height, int spp, int depth, int n_lights, int n_materials, int flags,
                                       void* stream) {
  return pt_render_forward_occupancy_media(sv, n_sv, keys, out, nullptr, width, height, spp, depth, n_lights,
                                           n_materials, flags, stream);
}

extern "C" int pt_render_forward_media_mesh(const float* sv, int n_sv, const uint32_t* keys, float* out, int width,
                                            int height, int spp, int depth, int n_lights, int n_materials, int flags,
                                            const int* topo, int n_tris, int n_verts, void* stream) {
  return pt_render_forward_occupancy_media_mesh(sv, n_sv, keys, out, nullptr, width, height, spp, depth, n_lights,
                                                n_materials, flags, topo, n_tris, n_verts, stream);
}

extern "C" int pt_render_forward_media_bigmesh(const float* sv, int n_sv, const uint32_t* keys, float* out, int width,
                                               int height, int spp, int depth, int n_lights, int n_materials,
                                               int flags, const float* coef, const float* attr, const float* aabb,
                                               int n_chunks, void* stream) {
  return pt_render_forward_occupancy_media_bigmesh(sv, n_sv, keys, out, nullptr, width, height, spp, depth, n_lights,
                                                   n_materials, flags, coef, attr, aabb, n_chunks, stream);
}

extern "C" const char* pt_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }
