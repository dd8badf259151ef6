// K1's and K3's entry points for the analytical and big mesh backends,
// with and without the medium (megakernel_fwd.cuh holds the template, its
// design and what bounds it). The SDF backend's are megakernel_sdf.cu's, a
// library built for each scene's primitive counts; the small mesh's are
// megakernel_mesh.cu's, a library built without FMA contraction. Every
// entry point takes a pixel range [p_begin, p_begin + p_count) of the
// frame, the whole frame (0, W * H) or a rank's share of it, and writes
// only its pixels.

#include "megakernel_fwd.cuh"

// Exported by the libraries whose K1 and K3 entry points take the pixel
// range, which tools that launch another tree's libraries ask for.
extern "C" int pt_forward_takes_range() { return 1; }

// K3's entry points, one per backend: one frame's pixel range, and the
// bounces each sample's path entered alive written to `entered` (int32
// [spp, H, W]) there; with a null `entered` the launch is K1's. 0 =
// success, else a cudaError_t.
extern "C" int pt_render_forward_occupancy(const float* sv, int n_sv, const uint32_t* keys, float* out, int* entered,
                                           int width, int height, int spp, int depth, int n_lights, int n_materials,
                                           int flags, int p_begin, int p_count, void* stream) {
  const pt::SceneView s = pt::analytical_view(nullptr, n_lights, n_materials, (flags & pt::FLAG_RESPECT_MAX_DIST) != 0);
  return pt::launch_forward<pt::Analytical>(sv, n_sv, keys, out, entered, width, height, spp, depth, flags, p_begin,
                                            p_count, s, stream);
}

// The big mesh scene with its tables on the card: coef [n_chunks * 128, 16],
// attr [8, n_chunks * 128], aabb [n_chunks, 8], float32.
extern "C" int pt_render_forward_occupancy_bigmesh(const float* sv, int n_sv, const uint32_t* keys, float* out,
                                                   int* entered, int width, int height, int spp, int depth,
                                                   int n_lights, int n_materials, int flags, const float* coef,
                                                   const float* attr, const float* aabb, int n_chunks, int p_begin,
                                                   int p_count, void* stream) {
  const pt::SceneView s = pt::bigmesh_view(nullptr, n_lights, n_materials, coef, attr, aabb, n_chunks);
  return pt::launch_forward<pt::BigMesh>(sv, n_sv, keys, out, entered, width, height, spp, depth, flags, p_begin,
                                         p_count, s, stream);
}

// K1's entry points: K3's arguments without `entered`.
extern "C" int pt_render_forward(const float* sv, int n_sv, const uint32_t* keys, float* out, int width, int height,
                                 int spp, int depth, int n_lights, int n_materials, int flags, int p_begin,
                                 int p_count, void* stream) {
  return pt_render_forward_occupancy(sv, n_sv, keys, out, nullptr, width, height, spp, depth, n_lights, n_materials,
                                     flags, p_begin, p_count, stream);
}

extern "C" int pt_render_forward_bigmesh(const float* sv, int n_sv, const uint32_t* keys, float* out, int width,
                                         int height, int spp, int depth, int n_lights, int n_materials, int flags,
                                         const float* coef, const float* attr, const float* aabb, int n_chunks,
                                         int p_begin, int p_count, void* stream) {
  return pt_render_forward_occupancy_bigmesh(sv, n_sv, keys, out, nullptr, width, height, spp, depth, n_lights,
                                             n_materials, flags, coef, attr, aabb, n_chunks, p_begin, p_count, stream);
}

// The media instantiation's entry points, K3's and K1's for each backend:
// the same arguments as the media-free ones, over a packed vector whose
// material records hold 26 scalars.
extern "C" int pt_render_forward_occupancy_media(const float* sv, int n_sv, const uint32_t* keys, float* out,
                                                 int* entered, int width, int height, int spp, int depth, int n_lights,
                                                 int n_materials, int flags, int p_begin, int p_count, void* stream) {
  const pt::SceneView s = pt::analytical_view(nullptr, n_lights, n_materials, (flags & pt::FLAG_RESPECT_MAX_DIST) != 0);
  return pt::launch_forward<pt::Analytical, true>(sv, n_sv, keys, out, entered, width, height, spp, depth, flags,
                                                  p_begin, p_count, s, stream);
}

extern "C" int pt_render_forward_occupancy_media_bigmesh(const float* sv, int n_sv, const uint32_t* keys, float* out,
                                                         int* entered, int width, int height, int spp, int depth,
                                                         int n_lights, int n_materials, int flags, const float* coef,
                                                         const float* attr, const float* aabb, int n_chunks,
                                                         int p_begin, int p_count, void* stream) {
  const pt::SceneView s = pt::bigmesh_view(nullptr, n_lights, n_materials, coef, attr, aabb, n_chunks);
  return pt::launch_forward<pt::BigMesh, true>(sv, n_sv, keys, out, entered, width, height, spp, depth, flags,
                                               p_begin, p_count, s, stream);
}

extern "C" int pt_render_forward_media(const float* sv, int n_sv, const uint32_t* keys, float* out, int width,
                                       int height, int spp, int depth, int n_lights, int n_materials, int flags,
                                       int p_begin, int p_count, void* stream) {
  return pt_render_forward_occupancy_media(sv, n_sv, keys, out, nullptr, width, height, spp, depth, n_lights,
                                           n_materials, flags, p_begin, p_count, stream);
}

extern "C" int pt_render_forward_media_bigmesh(const float* sv, int n_sv, const uint32_t* keys, float* out, int width,
                                               int height, int spp, int depth, int n_lights, int n_materials,
                                               int flags, const float* coef, const float* attr, const float* aabb,
                                               int n_chunks, int p_begin, int p_count, void* stream) {
  return pt_render_forward_occupancy_media_bigmesh(sv, n_sv, keys, out, nullptr, width, height, spp, depth, n_lights,
                                                   n_materials, flags, coef, attr, aabb, n_chunks, p_begin, p_count,
                                                   stream);
}

// The resources of K1's instantiation (K3's with `count`, MEDIA with
// `media`) of backend 0 (analytical) or 3 (big mesh; the SDF scene's, 1,
// are megakernel_sdf.cu's, the small mesh's, 2, megakernel_mesh.cu's) for
// n_sv scalars and n_tris triangles, into out[4] (megakernel_fwd.cuh
// forward_resources).
extern "C" int pt_forward_resources(int backend, int media, int count, int n_sv, int n_tris, int* out) {
  const int which = 4 * backend + 2 * (media != 0) + (count != 0);
  switch (which) {
#define PT_RESOURCES(b, B)                                                         \
  case 4 * b: return pt::forward_resources<B, false, false>(n_sv, n_tris, out);    \
  case 4 * b + 1: return pt::forward_resources<B, false, true>(n_sv, n_tris, out); \
  case 4 * b + 2: return pt::forward_resources<B, true, false>(n_sv, n_tris, out); \
  case 4 * b + 3: return pt::forward_resources<B, true, true>(n_sv, n_tris, out);
    PT_RESOURCES(0, pt::Analytical)
    PT_RESOURCES(3, pt::BigMesh)
#undef PT_RESOURCES
    default: return (int)cudaErrorInvalidValue;
  }
}

// The layout of K1's and K3's instantiation (MEDIA with `media`) of the same
// backends, into out[2]: dynamic shared bytes a block and the tile's paths,
// 0 for the per-thread loop (megakernel_fwd.cuh forward_layout).
extern "C" int pt_forward_layout(int backend, int media, int n_sv, int n_tris, long long* out) {
  switch (2 * backend + (media != 0)) {
#define PT_LAYOUT(b, B)                                                  \
  case 2 * b: pt::forward_layout<B, false>(n_sv, n_tris, out); return 0; \
  case 2 * b + 1: pt::forward_layout<B, true>(n_sv, n_tris, out); return 0;
    PT_LAYOUT(0, pt::Analytical)
    PT_LAYOUT(3, pt::BigMesh)
#undef PT_LAYOUT
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* pt_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }
