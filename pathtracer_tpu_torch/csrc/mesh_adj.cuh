// Reverse-mode adjoint of the small triangle-mesh backend (mesh.cuh): K7
// inside K2. Port of what jax.vjp differentiates in
// pathtracer_tpu/ops/megakernel_mesh.py (_tri_ts, _closest_hit_mesh,
// _background_mesh), held to torch autograd of models/mesh.
//
// The vertex positions are packed scalars, so their gradients flow through
// the hit distance (Möller-Trumbore's t, ray_triangle_adj) and the winner's
// face-forward normal, safe_normalize((b - a) x (c - a)) times a sign that
// is piecewise constant. The tie rule is K1's and JAX's: the first minimum
// (strict <) wins, and at a tie in t (an edge two triangles share) the
// whole cotangent goes to the first triangle, not shared as jnp.min shares
// it (analytical_adj.cuh). The winner is the triangle's index, which K2's
// record kernel finds with K1's unfused tests and its tie rule and the
// adjoint reads back; the hit test, the winner search and the shadow ray's
// any hit are boolean and carry none. The topology comes with the launch,
// which both of K2's kernels copy to shared memory as K1 does.
#pragma once

#include "intersect_adj.cuh"
#include "mesh.cuh"
#include "scene_adj.cuh"

namespace pt {

// The mesh backend with the hooks K2's two kernels call.
struct MeshAdj : Mesh {
  // Mesh::closest_hit's search: t (+inf on a miss) and the winning triangle.
  __device__ __forceinline__ static float closest_hit_rec(const SceneView& s, V3 ro, V3 rd, int& win) {
    float best = INFINITY;
    win = 0;
    for (int i = 0; i < s.n_tris; ++i) {
      const float t = mesh_triangle(s, i, ro, rd);
      if (t < best) {
        best = t;
        win = i;
      }
    }
    return isfinite(best) ? best : INFINITY;
  }
  // Mesh::closest_hit's normal and raw material on a ray that hit triangle
  // `win`, in its arithmetic.
  template <class M>
  __device__ __forceinline__ static void surface(const SceneView& s, V3 ro, V3 rd, float t, int win, V3& normal,
                                                 M& mat) {
    const int* tri = s.topo + 4 * win;
    const V3 a = mesh_vertex(s, tri[0]);
    const V3 n = safe_normalize_rn(cross_rn(mesh_vertex(s, tri[1]) - a, mesh_vertex(s, tri[2]) - a));
    normal = dot_rn(n, rd) > 0.0f ? -n : n;
    load_material(s, tri[3], mat);
  }
  // On a ray that hit triangle `idx`: the cotangents of t, the normal and
  // the raw material record.
  template <class A>
  __device__ __forceinline__ static void closest_hit_adj(const SceneView& s, V3 ro, V3 rd, float t, int idx,
                                                         float ct_t, V3 ct_normal, const A& a, const GradSink& g,
                                                         V3& c_ro, V3& c_rd) {
    const int* tri = s.topo + 4 * idx;
    scatter_material_adj(g, material_offset(s, tri[3], a), a, true);
    const V3 va = mesh_vertex(s, tri[0]), vb = mesh_vertex(s, tri[1]), vc = mesh_vertex(s, tri[2]);
    V3 c_a = splat3(0.0f), c_b = splat3(0.0f), c_c = splat3(0.0f);
    ray_triangle_adj(ro, rd, va, vb, vc, ct_t, c_ro, c_rd, c_a, c_b, c_c);
    // normal = sign * safe_normalize(e1 x e2), e1 = b - a, e2 = c - a
    const V3 e1 = vb - va, e2 = vc - va;
    const V3 cr = cross_rn(e1, e2);
    const V3 c_n = dot_rn(safe_normalize_rn(cr), rd) > 0.0f ? -ct_normal : ct_normal;
    V3 c_e1 = splat3(0.0f), c_e2 = splat3(0.0f);
    cross_adj(e1, e2, safe_normalize_adj(cr, c_n), c_e1, c_e2);
    c_a -= c_e1 + c_e2;
    g.add3(MESH_VERTS + 3 * tri[0], c_a);
    g.add3(MESH_VERTS + 3 * tri[1], c_b + c_e1);
    g.add3(MESH_VERTS + 3 * tri[2], c_c + c_e2);
  }
  __device__ __forceinline__ static void background_adj(const SceneView& s, V3 rd, V3 ct, const GradSink& g,
                                                        V3& c_rd) {
    sky_background_adj(s, s.lights_at - MESH_SKY, rd, ct, g, c_rd);
  }
};

}  // namespace pt
