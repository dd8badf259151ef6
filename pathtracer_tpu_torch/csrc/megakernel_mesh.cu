// K1's and K3's entry points for the small mesh backend (K7, mesh.cuh),
// with and without the medium (megakernel_fwd.cuh's template for Mesh),
// and K2's media-free record and adjoint kernels for it (megakernel_bwd.cuh's
// for MeshAdj; its MEDIA ones are megakernel_bwd_media.cu's), in a library
// of their own because ops/_build.py compiles it without FMA contraction
// (-fmad=false). The small mesh runs the compacted loop
// (megakernel_fwd.cuh Tiling), whose frames and K3 counts must be the
// per-thread loop's bit for bit. Contracted, they were not: the hand-off
// between the phases (t, the normal, the material), the light sample and
// the shadow ray agreed, but nvcc fused the Disney BSDF's products into its
// sums at other places in the two loops' inlined copies of disney_eval and
// disney_sample, so 1-ulp differences at bounce 0 grew to 1.8e-4 in the
// frame (up to 0.30, and other path lengths, in the glass Scatter scene).
// Rounded apart, every product and sum rounds as the plain version's
// separate operations do, in both loops alike (tools/k1_pair on an H100
// 80GB HBM3 at 700 W: bit-equal with and without the medium; PERF.md). K2's
// record kernel traces the same paths again (its records are K1's bounces,
// which the adjoint differentiates), so it is built alike: each path's
// bounces are K3's counts (chip_smoke.py phase 21). The other backends'
// instantiations keep nvcc's default in megakernel_fwd.cu and
// megakernel_bwd.cu.

#include "megakernel_bwd.cuh"
#include "megakernel_fwd.cuh"

// K3's entry point: one frame's pixel range [p_begin, p_begin + p_count) of
// the mesh scene with its topology [n_tris, 4] int32 (a, b, c, material)
// on the card, and the bounces each sample's path entered alive written to
// `entered` (int32 [spp, H, W]) there; with a null `entered` the launch is
// K1's. 0 = success, else a cudaError_t.
extern "C" int pt_render_forward_occupancy_mesh(const float* sv, int n_sv, const uint32_t* keys, float* out,
                                                int* entered, int width, int height, int spp, int depth,
                                                int n_lights, int n_materials, int flags, const int* topo, int n_tris,
                                                int n_verts, int p_begin, int p_count, void* stream) {
  const pt::SceneView s = pt::mesh_view(nullptr, n_lights, n_materials, topo, n_tris, n_verts);
  return pt::launch_forward<pt::Mesh>(sv, n_sv, keys, out, entered, width, height, spp, depth, flags, p_begin, p_count,
                                      s, stream);
}

// K1's: K3's arguments without `entered`.
extern "C" int pt_render_forward_mesh(const float* sv, int n_sv, const uint32_t* keys, float* out, int width,
                                      int height, int spp, int depth, int n_lights, int n_materials, int flags,
                                      const int* topo, int n_tris, int n_verts, int p_begin, int p_count,
                                      void* stream) {
  return pt_render_forward_occupancy_mesh(sv, n_sv, keys, out, nullptr, width, height, spp, depth, n_lights,
                                          n_materials, flags, topo, n_tris, n_verts, p_begin, p_count, stream);
}

// The media instantiation's: the same arguments over a packed vector whose
// material records hold 26 scalars.
extern "C" int pt_render_forward_occupancy_media_mesh(const float* sv, int n_sv, const uint32_t* keys, float* out,
                                                      int* entered, int width, int height, int spp, int depth,
                                                      int n_lights, int n_materials, int flags, const int* topo,
                                                      int n_tris, int n_verts, int p_begin, int p_count,
                                                      void* stream) {
  const pt::SceneView s = pt::mesh_view(nullptr, n_lights, n_materials, topo, n_tris, n_verts);
  return pt::launch_forward<pt::Mesh, true>(sv, n_sv, keys, out, entered, width, height, spp, depth, flags, p_begin,
                                            p_count, s, stream);
}

extern "C" int pt_render_forward_media_mesh(const float* sv, int n_sv, const uint32_t* keys, float* out, int width,
                                            int height, int spp, int depth, int n_lights, int n_materials, int flags,
                                            const int* topo, int n_tris, int n_verts, int p_begin, int p_count,
                                            void* stream) {
  return pt_render_forward_occupancy_media_mesh(sv, n_sv, keys, out, nullptr, width, height, spp, depth, n_lights,
                                                n_materials, flags, topo, n_tris, n_verts, p_begin, p_count, stream);
}

extern "C" int pt_forward_takes_range() { return 1; }

// K1's and K3's resources and layout (megakernel_fwd.cu's
// pt_forward_resources and pt_forward_layout) for backend 2, the small mesh.
extern "C" int pt_forward_resources(int backend, int media, int count, int n_sv, int n_tris, int* out) {
  if (backend != 2) return (int)cudaErrorInvalidValue;
  switch (2 * (media != 0) + (count != 0)) {
    case 0: return pt::forward_resources<pt::Mesh, false, false>(n_sv, n_tris, out);
    case 1: return pt::forward_resources<pt::Mesh, false, true>(n_sv, n_tris, out);
    case 2: return pt::forward_resources<pt::Mesh, true, false>(n_sv, n_tris, out);
    default: return pt::forward_resources<pt::Mesh, true, true>(n_sv, n_tris, out);
  }
}

extern "C" int pt_forward_layout(int backend, int media, int n_sv, int n_tris, long long* out) {
  if (backend != 2) return (int)cudaErrorInvalidValue;
  media ? pt::forward_layout<pt::Mesh, true>(n_sv, n_tris, out)
        : pt::forward_layout<pt::Mesh, false>(n_sv, n_tris, out);
  return 0;
}

// K2's media-free entry points for the small mesh (megakernel_bwd.cu's
// pt_render_backward_record and pt_render_backward_adjoint, with the
// topology after the flags); the reduction is megakernel_bwd.cu's.
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

// Their resources (megakernel_bwd.cu's pt_backward_resources) for backend
// 2, the small mesh.
extern "C" int pt_backward_resources(int backend, int n_sv, int n_tris, int* out) {
  if (backend != 2) return (int)cudaErrorInvalidValue;
  return pt::backward_resources<pt::MeshAdj>(n_sv, n_tris, out);
}

extern "C" const char* pt_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }
