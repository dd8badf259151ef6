// Scalar per-thread twin of models/mesh.py: the small triangle-mesh backend
// of the generic tracer (K7 inside K1, K3 and K2).
//
// Replaces the TPU backend pathtracer_tpu/ops/megakernel_mesh.py (_tri_ts,
// _closest_hit_mesh, _any_hit_mesh, _background_mesh). The packed layout is
// ops/megakernel_mesh.pack_mesh_scene's (scene.cuh has the rest):
//
//   [0, 12)   camera
//   V x 3     vertices
//   7         sky horizon(3) zenith(3) scale
//   L x 15, M x 20   lights and materials
//
// The topology, (a, b, c, material) per triangle, comes with the launch as
// an int table. The JAX kernel unrolls it at trace time; here the block's
// threads stage a triangle table in shared memory at the start of each
// kernel (stage_mesh_triangle: MESH_ROWS float4 rows a triangle, its first
// vertex, both edges and its geometric normal, with the indices in the rows'
// fourth lanes), so a test reads three rows that every lane of a warp reads
// at once (one broadcast each) and forms no edge, and the winner's normal
// is a load. A thread tests every triangle in order (first minimum wins,
// strict <) and takes the winner's normal turned against the ray.
// Two-sided Möller-Trumbore is intersect.cuh's ray_triangle_edges,
// unfused as the plain version rounds it. K1 and K3 run the mesh in the
// compacted loop, from megakernel_mesh.cu (built without contraction, so
// that their frames are the per-thread loop's bit for bit).
//
// What bounds it on this card: operations, ~54 per triangle test and ~20
// tests per closest hit and per shadow ray, all on data in shared memory.
#pragma once

#include <type_traits>

#include "tracer.cuh"

namespace pt {

constexpr int MESH_VERTS = 12;  // the first vertex, after the camera
constexpr int MESH_SKY = 7;

// Where the light records start (host side, for the launch).
inline int mesh_lights_at(int n_verts) { return MESH_VERTS + 3 * n_verts + MESH_SKY; }

// The mesh scene's view with its topology (host side, as above); the
// kernels point `tris` at the table they stage.
inline SceneView mesh_view(const float* sv, int n_lights, int n_materials, const int* topo, int n_tris, int n_verts) {
  SceneView s = {sv, n_lights, n_materials, false, mesh_lights_at(n_verts), 0, 0, 0};
  s.topo = topo;
  s.n_tris = n_tris;
  return s;
}

// The staged triangle table, MESH_ROWS float4 rows a triangle (a, b, c):
//   a's position          | the material's index
//   e1 = b - a            | a
//   e2 = c - a            | b
//   safe_normalize_rn(cross_rn(e1, e2)), the geometric normal | c
// the indices as floats (exact below 2^24).
constexpr int MESH_ROWS = 4;
constexpr int MESH_ROW_BYTES = MESH_ROWS * 16;

__host__ __device__ inline size_t align16(size_t bytes) { return (bytes + 15) & ~(size_t)15; }

// The bytes of a block's shared memory up to the end of a triangle table of
// n_tris triangles staged after `bytes` of it (16-byte aligned for its
// float4 rows; align16(bytes) is where it starts).
__host__ __device__ inline size_t table_end(size_t bytes, int n_tris) {
  return align16(bytes) + (size_t)n_tris * MESH_ROW_BYTES;
}

__device__ __forceinline__ float4 row4(V3 v, float w) { return float4{v.x, v.y, v.z, w}; }
__device__ __forceinline__ V3 xyz(float4 r) { return v3(r.x, r.y, r.z); }

// Triangle i's rows of the table, from the packed vector `sv` and the
// topology.
__device__ __forceinline__ void stage_mesh_triangle(const float* sv, const int* topo, int i, float4* table) {
  const int* tri = topo + 4 * i;
  const V3 a = load3(sv + MESH_VERTS + 3 * tri[0]);
  const V3 e1 = load3(sv + MESH_VERTS + 3 * tri[1]) - a, e2 = load3(sv + MESH_VERTS + 3 * tri[2]) - a;
  float4* r = table + MESH_ROWS * i;
  r[0] = row4(a, (float)tri[3]);
  r[1] = row4(e1, (float)tri[0]);
  r[2] = row4(e2, (float)tri[1]);
  r[3] = row4(safe_normalize_rn(cross_rn(e1, e2)), (float)tri[2]);
}

__device__ __forceinline__ const float4* mesh_rows(const SceneView& s, int i) { return s.tris + MESH_ROWS * i; }

// Triangle i's vertex k (0, 1, 2: a, b, c) and material, by index.
__device__ __forceinline__ int mesh_index(const SceneView& s, int i, int k) { return (int)mesh_rows(s, i)[k + 1].w; }
__device__ __forceinline__ int mesh_material(const SceneView& s, int i) { return (int)mesh_rows(s, i)[0].w; }
__device__ __forceinline__ V3 mesh_vertex(const SceneView& s, int v) { return load3(s.sv + MESH_VERTS + 3 * v); }

__device__ __forceinline__ float mesh_triangle(const SceneView& s, int i, V3 ro, V3 rd) {
  const float4* r = mesh_rows(s, i);
  return ray_triangle_edges(ro, rd, xyz(r[0]), xyz(r[1]), xyz(r[2]));
}

// Triangle i's geometric normal turned against rd.
__device__ __forceinline__ V3 mesh_normal(const SceneView& s, int i, V3 rd) {
  const V3 n = xyz(mesh_rows(s, i)[3]);
  return dot_rn(n, rd) > 0.0f ? -n : n;
}

// The mesh backend of the generic tracer.
struct Mesh {
  // First minimum over the triangles; on a miss triangle 0's normal and the
  // default material, as the JAX where-chain leaves them.
  template <class M = Material>
  __device__ __forceinline__ static float closest_hit(const SceneView& s, V3 ro, V3 rd, V3& normal, M& mat) {
    float best = INFINITY;
    int idx = 0;
    for (int i = 0; i < s.n_tris; ++i) {
      const float t = mesh_triangle(s, i, ro, rd);
      if (t < best) {
        best = t;
        idx = i;
      }
    }
    normal = mesh_normal(s, idx, rd);
    if (!isfinite(best)) {
      mat = default_material();
      return INFINITY;
    }
    load_material(s, mesh_material(s, idx), mat);
    return best;
  }

  // Occlusion closer than max_dist (the fixed semantics).
  __device__ __forceinline__ static bool any_hit(const SceneView& s, V3 ro, V3 rd, float max_dist) {
    for (int i = 0; i < s.n_tris; ++i) {
      if (mesh_triangle(s, i, ro, rd) < max_dist) return true;
    }
    return false;
  }

  __device__ __forceinline__ static V3 background(const SceneView& s, V3 rd) {
    return sky_background(s.sv + s.lights_at - MESH_SKY, rd);
  }
};

// Whether a backend's kernels stage the triangle table (Mesh, and K2's
// MeshAdj): the other instantiations compile no staging.
template <class B>
constexpr bool STAGED_TABLE = std::is_base_of_v<Mesh, B>;

}  // namespace pt
