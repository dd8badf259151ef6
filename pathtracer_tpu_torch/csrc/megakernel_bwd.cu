// K2's media-free entry points (the analytical, SDF and mesh instantiations
// of megakernel_bwd.cuh's template: its record kernel and adjoint kernel),
// its reduction and its helpers. The MEDIA instantiations are
// megakernel_bwd_media.cu, a library of their own.

#include "megakernel_bwd.cuh"

extern "C" int pt_backward_threads() { return pt::BWD_THREADS; }
extern "C" int pt_backward_sdf_max_primitives() { return pt::SDF_MAX_PRIMS; }
extern "C" int pt_backward_max_lights() { return pt::REC_MAX_LIGHTS; }
extern "C" size_t pt_backward_record_cap() { return pt::REC_CAP_BYTES; }

// Dynamic shared memory the adjoint kernel needs for n_sv scene scalars and
// a topology of n_tris triangles (0 but for the small mesh).
extern "C" size_t pt_backward_smem_bytes(int n_sv, int n_tris) { return pt::backward_smem_bytes(n_sv, n_tris); }

// The record buffer's bytes for a frame of n pixels, spp samples and depth
// bounces (`media`: the MEDIA instantiation's records) under `cap` bytes
// (at most pt_backward_record_cap()), and its chunks: plan[0] pixels and
// plan[1] samples a chunk. 0 where one block's records of one sample
// exceed the cap.
extern "C" size_t pt_backward_record_bytes(int n, int spp, int depth, int media, size_t cap, int* plan) {
  const int words = media ? pt::REC_WORDS_MEDIA : pt::REC_WORDS;
  const pt::RecordPlan pl = pt::record_plan(n, spp, depth, words, cap);
  plan[0] = pl.pixels;
  plan[1] = pl.samples;
  return pl.samples > 0 ? pt::record_bytes(pl, depth, words) : 0;
}

// K2's entry points, two an instantiation (0 = success, else a
// cudaError_t): `_record` launches the record kernel for one chunk
// (p0, pixels, k0, samples) of the frame into rec, which holds
// pt_backward_record_bytes of the chunk's plan; `_adjoint` launches the
// adjoint kernel for the same chunk from those records into partial
// [ceil(W*H/THREADS)][n_sv] (megakernel_bwd.cuh launch_record,
// launch_adjoint). ops/megakernel.launch_backward runs the chunks, then
// pt_backward_reduce. The analytical scene's:
extern "C" int pt_render_backward_record(const float* sv, int n_sv, const uint32_t* keys, float* rec, int width,
                                         int height, int spp, int depth, int n_lights, int n_materials, int flags,
                                         int p0, int pixels, int k0, int samples, void* stream) {
  const pt::SceneView s = pt::analytical_view(nullptr, n_lights, n_materials, (flags & pt::FLAG_RESPECT_MAX_DIST) != 0);
  return pt::launch_record<pt::AnalyticalAdj>(sv, n_sv, keys, rec, width, height, spp, depth, flags, s,
                                              {p0, pixels, k0, samples}, stream);
}

extern "C" int pt_render_backward_adjoint(const float* sv, int n_sv, const uint32_t* keys, const float* ct,
                                          float* rec, float* partial, int width, int height, int spp, int depth,
                                          int n_lights, int n_materials, int flags, int p0, int pixels, int k0,
                                          int samples, void* stream) {
  const pt::SceneView s = pt::analytical_view(nullptr, n_lights, n_materials, (flags & pt::FLAG_RESPECT_MAX_DIST) != 0);
  return pt::launch_adjoint<pt::AnalyticalAdj>(sv, n_sv, keys, ct, rec, partial, width, height, spp, depth, flags,
                                               s, {p0, pixels, k0, samples}, stream);
}

// The SDF scene's, with its primitive counts (more than
// pt_backward_sdf_max_primitives() primitives, the plane included, is
// cudaErrorInvalidValue).
extern "C" int pt_render_backward_sdf_record(const float* sv, int n_sv, const uint32_t* keys, float* rec, int width,
                                             int height, int spp, int depth, int n_lights, int n_materials,
                                             int flags, int n_spheres, int n_boxes, int n_tori, int p0, int pixels,
                                             int k0, int samples, void* stream) {
  if (n_spheres + n_boxes + n_tori + 1 > pt::SDF_MAX_PRIMS) return (int)cudaErrorInvalidValue;
  const pt::SceneView s = pt::sdf_view(nullptr, n_lights, n_materials, n_spheres, n_boxes, n_tori);
  return pt::launch_record<pt::SdfAdj>(sv, n_sv, keys, rec, width, height, spp, depth, flags, s,
                                       {p0, pixels, k0, samples}, stream);
}

extern "C" int pt_render_backward_sdf_adjoint(const float* sv, int n_sv, const uint32_t* keys, const float* ct,
                                              float* rec, float* partial, int width, int height, int spp, int depth,
                                              int n_lights, int n_materials, int flags, int n_spheres, int n_boxes,
                                              int n_tori, int p0, int pixels, int k0, int samples, void* stream) {
  if (n_spheres + n_boxes + n_tori + 1 > pt::SDF_MAX_PRIMS) return (int)cudaErrorInvalidValue;
  const pt::SceneView s = pt::sdf_view(nullptr, n_lights, n_materials, n_spheres, n_boxes, n_tori);
  return pt::launch_adjoint<pt::SdfAdj>(sv, n_sv, keys, ct, rec, partial, width, height, spp, depth, flags, s,
                                        {p0, pixels, k0, samples}, stream);
}

// The small mesh scene's, with its topology [n_tris, 4] int32 (a, b, c,
// material) on the card.
extern "C" int pt_render_backward_mesh_record(const float* sv, int n_sv, const uint32_t* keys, float* rec, int width,
                                              int height, int spp, int depth, int n_lights, int n_materials,
                                              int flags, const int* topo, int n_tris, int n_verts, int p0,
                                              int pixels, int k0, int samples, void* stream) {
  const pt::SceneView s = pt::mesh_view(nullptr, n_lights, n_materials, topo, n_tris, n_verts);
  return pt::launch_record<pt::MeshAdj>(sv, n_sv, keys, rec, width, height, spp, depth, flags, s,
                                        {p0, pixels, k0, samples}, stream);
}

extern "C" int pt_render_backward_mesh_adjoint(const float* sv, int n_sv, const uint32_t* keys, const float* ct,
                                               float* rec, float* partial, int width, int height, int spp, int depth,
                                               int n_lights, int n_materials, int flags, const int* topo, int n_tris,
                                               int n_verts, int p0, int pixels, int k0, int samples, void* stream) {
  const pt::SceneView s = pt::mesh_view(nullptr, n_lights, n_materials, topo, n_tris, n_verts);
  return pt::launch_adjoint<pt::MeshAdj>(sv, n_sv, keys, ct, rec, partial, width, height, spp, depth, flags, s,
                                         {p0, pixels, k0, samples}, stream);
}

// grad[j] = the sum over the num_blocks rows of partial[.][n_sv], in a fixed
// order (megakernel_bwd.cuh reduce_blocks_kernel), on `stream`.
extern "C" int pt_backward_reduce(const float* partial, int num_blocks, int n_sv, float* grad, void* stream) {
  pt::reduce_blocks_kernel<<<n_sv, pt::REDUCE_THREADS, 0, (cudaStream_t)stream>>>(partial, num_blocks, n_sv, grad);
  return (int)cudaGetLastError();
}

// The record and adjoint kernels' resources of backend 0 (analytical), 1
// (SDF) or 2 (mesh) for n_sv scalars and n_tris triangles, into out[8]
// (megakernel_bwd.cuh backward_resources).
extern "C" int pt_backward_resources(int backend, int n_sv, int n_tris, int* out) {
  return pt::backward_resources_of<false>(backend, n_sv, n_tris, out);
}

extern "C" const char* pt_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }
