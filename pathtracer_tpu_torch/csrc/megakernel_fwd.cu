// Forward path-tracing megakernel (K1) on Hopper, generic over the scene
// backend: the analytical scene (analytical.cuh), the sphere-traced SDF
// scene (sdf.cuh, the port of the SDF backend K5), the small triangle mesh
// (mesh.cuh, K7) and the big one (bigmesh.cuh, K8); and its instrumented
// twin, the occupancy kernel K3, on the same four backends.
//
// Replaces the TPU kernel pathtracer_tpu/ops/megakernel.py::_pallas_forward
// (body _make_kernel -> _trace_tile -> _tile_bounce, over a KernelBackend).
// K3 replaces _pallas_forward_occupancy (_make_kernel(instrument=True) ->
// _trace_tile_counts), which adds, per tile of 8 x 128 lanes, the lanes
// alive entering each bounce. Here each thread renders its pixel exactly as
// K1 does and also writes, per sample, the bounces its path entered alive
// (the trips of its bounce loop) into an int32 [spp, H, W] array: any tiling
// (the TPU's tiles, this card's blocks and warps) reduces from it exactly,
// and the loop and its early exit stay K1's. K1's instantiation compiles no
// count (COUNT = false), as it compiles no topology copy outside the mesh.
// A scene whose material table declares a medium takes the MEDIA
// instantiation of both (_make_kernel with has_media: the segment inside a
// medium, the Scatter event, the medium transition; tracer.cuh), its own
// entry points over 26-scalar material records; the media-free
// instantiations compile none of it.
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
// march is done (grazing rays that never converge take all 96). On the mesh
// scenes the triangle tests do: 20 per ray for the small mesh (its topology
// copied to shared memory beside the packed vector), and 128 for each
// chunk of the big mesh that the ray's box test admits. This first version
// does nothing about either beyond __launch_bounds__.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "analytical.cuh"
#include "bigmesh.cuh"
#include "mesh.cuh"
#include "sdf.cuh"
#include "tracer.cuh"

namespace pt {

constexpr int THREADS = 128;
// Whether K1 copies the backend's topology to shared memory (mesh.cuh).
template <class B>
constexpr bool SHARED_TOPOLOGY = std::is_same_v<B, Mesh>;

template <class B, bool COUNT, bool MEDIA>
__global__ void __launch_bounds__(THREADS)
    render_forward_kernel(const float* __restrict__ sv_global, int n_sv, const uint32_t* __restrict__ keys,
                          float* __restrict__ out, int* __restrict__ entered, int width, int height, int spp,
                          int depth, int flags, SceneView s) {
  extern __shared__ float sv[];
  for (int i = threadIdx.x; i < n_sv; i += blockDim.x) sv[i] = sv_global[i];
  // The small mesh's topology beside the packed vector; the other backends
  // have none, and their instantiations compile no copy.
  int* topo = reinterpret_cast<int*>(sv + n_sv);
  if constexpr (SHARED_TOPOLOGY<B>) {
    for (int i = threadIdx.x; i < 4 * s.n_tris; i += blockDim.x) topo[i] = s.topo[i];
  }
  __syncthreads();

  const int n = width * height;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;

  s.sv = sv;
  if constexpr (SHARED_TOPOLOGY<B>) s.topo = topo;
  V3 sum = splat3(0.0f);
  for (int k = 0; k < spp; ++k) {
    const uint32_t* kk = keys + 4 * k;  // (kc0, kc1, kb0, kb1) of sample k
    int e = 0;  // the bounces entered, which K1 (COUNT = false) neither counts nor writes
    V3 r = trace_sample<B, COUNT, MEDIA>(s, p, n, width, height, depth, flags, kk[0], kk[1], kk[2], kk[3], &e);
    if constexpr (COUNT) entered[k * n + p] = e;
    sum = k == 0 ? r : sum + r;
  }
  if (spp > 1) sum = sum / (float)spp;
  float4* o = reinterpret_cast<float4*>(out) + p;
  *o = make_float4(sum.x, sum.y, sum.z, 1.0f);
}

// Launches one frame on `stream`: K1, or K3 when `entered` (int32 [spp, H,
// W]) is given; `s` is the scene's structure (its sv and topology are set to
// the shared copies in the kernel); MEDIA selects the media instantiation.
// Returns cudaGetLastError().
template <class B, bool MEDIA = false>
int launch_forward(const float* sv, int n_sv, const uint32_t* keys, float* out, int* entered, int width,
                   int height, int spp, int depth, int flags, SceneView s, void* stream) {
  const int n = width * height;
  const int blocks = (n + THREADS - 1) / THREADS;
  const size_t smem = n_sv * sizeof(float) + 4 * s.n_tris * sizeof(int);
  if (entered == nullptr) {
    render_forward_kernel<B, false, MEDIA><<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
        sv, n_sv, keys, out, nullptr, width, height, spp, depth, flags, s);
  } else {
    render_forward_kernel<B, true, MEDIA><<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
        sv, n_sv, keys, out, entered, width, height, spp, depth, flags, s);
  }
  return (int)cudaGetLastError();
}

}  // namespace pt

// K3's entry points, one per backend: one frame, and the bounces each
// sample's path entered alive written to `entered` (int32 [spp, H, W]); with a
// null `entered` the launch is K1's. 0 = success, else a cudaError_t.
extern "C" int pt_render_forward_occupancy(const float* sv, int n_sv, const uint32_t* keys, float* out, int* entered,
                                           int width, int height, int spp, int depth, int n_lights, int n_materials,
                                           int flags, void* stream) {
  const pt::SceneView s = pt::analytical_view(nullptr, n_lights, n_materials, (flags & pt::FLAG_RESPECT_MAX_DIST) != 0);
  return pt::launch_forward<pt::Analytical>(sv, n_sv, keys, out, entered, width, height, spp, depth, flags, s, stream);
}

// The SDF scene with its primitive counts.
extern "C" int pt_render_forward_occupancy_sdf(const float* sv, int n_sv, const uint32_t* keys, float* out,
                                               int* entered, int width, int height, int spp, int depth, int n_lights,
                                               int n_materials, int flags, int n_spheres, int n_boxes, int n_tori,
                                               void* stream) {
  const pt::SceneView s = pt::sdf_view(nullptr, n_lights, n_materials, n_spheres, n_boxes, n_tori);
  return pt::launch_forward<pt::Sdf>(sv, n_sv, keys, out, entered, width, height, spp, depth, flags, s, stream);
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

extern "C" int pt_render_forward_sdf(const float* sv, int n_sv, const uint32_t* keys, float* out, int width,
                                     int height, int spp, int depth, int n_lights, int n_materials, int flags,
                                     int n_spheres, int n_boxes, int n_tori, void* stream) {
  return pt_render_forward_occupancy_sdf(sv, n_sv, keys, out, nullptr, width, height, spp, depth, n_lights,
                                         n_materials, flags, n_spheres, n_boxes, n_tori, stream);
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

extern "C" int pt_render_forward_occupancy_media_sdf(const float* sv, int n_sv, const uint32_t* keys, float* out,
                                                     int* entered, int width, int height, int spp, int depth,
                                                     int n_lights, int n_materials, int flags, int n_spheres,
                                                     int n_boxes, int n_tori, void* stream) {
  const pt::SceneView s = pt::sdf_view(nullptr, n_lights, n_materials, n_spheres, n_boxes, n_tori);
  return pt::launch_forward<pt::Sdf, true>(sv, n_sv, keys, out, entered, width, height, spp, depth, flags, s, stream);
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

extern "C" int pt_render_forward_media_sdf(const float* sv, int n_sv, const uint32_t* keys, float* out, int width,
                                           int height, int spp, int depth, int n_lights, int n_materials, int flags,
                                           int n_spheres, int n_boxes, int n_tori, void* stream) {
  return pt_render_forward_occupancy_media_sdf(sv, n_sv, keys, out, nullptr, width, height, spp, depth, n_lights,
                                               n_materials, flags, n_spheres, n_boxes, n_tori, stream);
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
