// Scalar per-thread twin of models/mesh.py: the small triangle-mesh backend
// of the generic tracer (K7 inside K1).
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
// an int table that K1 copies to shared memory beside the packed vector;
// the JAX kernel unrolls it at trace time instead. A thread tests every
// triangle in order (first minimum wins, strict <) and takes the winner's
// geometric normal turned against the ray. Two-sided Möller-Trumbore is
// intersect.cuh's ray_triangle, unfused as the plain version rounds it.
//
// What bounds it on this card: operations, ~40 per triangle test and ~20
// tests per closest hit and per shadow ray, all on data in shared memory.
#pragma once

#include "tracer.cuh"

namespace pt {

constexpr int MESH_VERTS = 12;  // the first vertex, after the camera
constexpr int MESH_SKY = 7;

// Where the light records start (host side, for the launch).
inline int mesh_lights_at(int n_verts) { return MESH_VERTS + 3 * n_verts + MESH_SKY; }

// The mesh scene's view with its topology (host side, as above).
inline SceneView mesh_view(const float* sv, int n_lights, int n_materials, const int* topo, int n_tris, int n_verts) {
  SceneView s = {sv, n_lights, n_materials, false, mesh_lights_at(n_verts), 0, 0, 0};
  s.topo = topo;
  s.n_tris = n_tris;
  return s;
}

__device__ __forceinline__ V3 mesh_vertex(const SceneView& s, int i) { return load3(s.sv + MESH_VERTS + 3 * i); }

__device__ __forceinline__ float mesh_triangle(const SceneView& s, int i, V3 ro, V3 rd) {
  const int* tri = s.topo + 4 * i;
  return ray_triangle(ro, rd, mesh_vertex(s, tri[0]), mesh_vertex(s, tri[1]), mesh_vertex(s, tri[2]));
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
    const int* tri = s.topo + 4 * idx;
    const V3 a = mesh_vertex(s, tri[0]);
    const V3 n = safe_normalize_rn(cross_rn(mesh_vertex(s, tri[1]) - a, mesh_vertex(s, tri[2]) - a));
    normal = dot_rn(n, rd) > 0.0f ? -n : n;
    if (!isfinite(best)) {
      mat = default_material();
      return INFINITY;
    }
    load_material(s, tri[3], mat);
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

}  // namespace pt
