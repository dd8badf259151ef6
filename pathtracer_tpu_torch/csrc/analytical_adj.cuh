// Reverse-mode adjoints of analytical.cuh (closest hit, background and the
// material pick), writing d(loss)/d(packed scene) through a GradSink, and
// AnalyticalAdj, the analytical backend of the adjoint tracer
// (tracer_adj.cuh). The closest hit's winner, as K2's record kernel writes
// it, is the mask of the primitives at the closest distance (bit 0 sphere
// 0, bit 1 sphere 1, bit 2 the plane): the first set bit is the primitive
// analytical.cuh's closest_hit picks, and a tie shares the distance's
// cotangent.
#pragma once

#include "analytical.cuh"
#include "intersect_adj.cuh"
#include "scene_adj.cuh"

namespace pt {

// The primitive a winner mask names: its first set bit.
__device__ __forceinline__ int analytical_primitive(int mask) { return (mask & 1) ? 0 : ((mask & 2) ? 1 : 2); }

// closest_hit's search: t (+inf on a miss) and the winner mask.
__device__ __forceinline__ float analytical_closest_hit_rec(const SceneView& s, V3 ro, V3 rd, int& mask) {
  float t0, t1, tp;
  primitive_ts(s, ro, rd, t0, t1, tp);
  float t = fminf(fminf(t0, t1), tp);
  mask = (t0 == t ? 1 : 0) | (t1 == t ? 2 : 0) | (tp == t ? 4 : 0);
  return isfinite(t) ? t : INFINITY;
}

// closest_hit's normal and raw material on a ray that hit primitive
// analytical_primitive(mask) at t, in its arithmetic.
template <class M>
__device__ __forceinline__ void analytical_surface(const SceneView& s, V3 ro, V3 rd, float t, int mask, V3& normal,
                                                   M& mat) {
  const int idx = analytical_primitive(mask);
  V3 hp = madd3(ro, rd, t);
  V3 center = load3(s.sv + SV_SPHERE_CENTER + (idx == 0 ? 0 : 3));
  normal = idx == 2 ? load3(s.sv + SV_PLANE_NORMAL) : safe_normalize(hp - center);
  load_material(s, min(idx, s.n_materials - 1), mat);
  if (idx == 2) {
    float safe_dy = rd.y != 0.0f ? rd.y : 1.0f;
    float cx = rd.x / safe_dy * s.sv[SV_CHECKER_SCALE] + s.sv[SV_CHECKER_OFFSET];
    float cy = rd.z / safe_dy * s.sv[SV_CHECKER_SCALE] + s.sv[SV_CHECKER_OFFSET];
    float x1 = fmodf(floorf(cx), 2.0f);
    float y1 = fmodf(floorf(cy), 2.0f);
    mat.rgb = splat3(fmodf(x1 + y1, 2.0f) < 1.0f ? s.sv[SV_CHECKER_ALBEDO] : s.sv[SV_CHECKER_ALBEDO + 1]);
  }
}

// closest_hit on a ray that hit at t with the winner mask: cotangents of t,
// of the geometric normal and of the raw material record (the plane's rgb
// is its checker albedo). A tie in the closest distance shares ct_t evenly,
// as jnp.min does. A (MatAdj, or MediaMatAdj in the media instantiation)
// sets the record's stride.
template <class A>
__device__ __forceinline__ void closest_hit_adj(const SceneView& s, V3 ro, V3 rd, float t, int mask, float ct_t,
                                                V3 ct_normal, const A& a, const GradSink& g, V3& c_ro, V3& c_rd) {
  int idx = analytical_primitive(mask);

  if (idx == 2) {
    g.add3(SV_PLANE_NORMAL, ct_normal);
  } else {
    int ci = SV_SPHERE_CENTER + (idx == 0 ? 0 : 3);
    V3 q = madd3(ro, rd, t) - load3(s.sv + ci);
    V3 c_q = safe_normalize_adj(q, ct_normal);
    g.add3(ci, -c_q);
    c_ro += c_q;
    c_rd += c_q * t;
    ct_t += dot(c_q, rd);
  }

  float ct_each = ct_t / (float)((mask & 1) + ((mask >> 1) & 1) + ((mask >> 2) & 1));
  for (int k = 0; k < 2; ++k) {
    if (!((mask >> k) & 1)) continue;
    int ci = SV_SPHERE_CENTER + 3 * k;
    V3 c_center = splat3(0.0f);
    float c_radius = 0.0f;
    ray_sphere_adj(ro, rd, load3(s.sv + ci), s.sv[SV_SPHERE_RADIUS + k], ct_each, c_ro, c_rd, c_center, c_radius);
    g.add3(ci, c_center);
    g.add(SV_SPHERE_RADIUS + k, c_radius);
  }
  if (mask & 4) {
    V3 c_n = splat3(0.0f), c_p = splat3(0.0f);
    ray_plane_adj(ro, rd, load3(s.sv + SV_PLANE_NORMAL), load3(s.sv + SV_PLANE_POINT), ct_each, c_ro, c_rd, c_n,
                  c_p);
    g.add3(SV_PLANE_NORMAL, c_n);
    g.add3(SV_PLANE_POINT, c_p);
  }

  scatter_material_adj(g, material_offset(s, min(idx, s.n_materials - 1), a), a, idx != 2);
  if (idx == 2) {
    float safe_dy = rd.y != 0.0f ? rd.y : 1.0f;
    float cx = rd.x / safe_dy * s.sv[SV_CHECKER_SCALE] + s.sv[SV_CHECKER_OFFSET];
    float cy = rd.z / safe_dy * s.sv[SV_CHECKER_SCALE] + s.sv[SV_CHECKER_OFFSET];
    float x1 = fmodf(floorf(cx), 2.0f);
    float y1 = fmodf(floorf(cy), 2.0f);
    g.add(SV_CHECKER_ALBEDO + (fmodf(x1 + y1, 2.0f) < 1.0f ? 0 : 1), a.rgb.x + a.rgb.y + a.rgb.z);
  }
}

// The analytical backend with the hooks K2's two kernels call.
struct AnalyticalAdj : Analytical {
  __device__ __forceinline__ static float closest_hit_rec(const SceneView& s, V3 ro, V3 rd, int& win) {
    return analytical_closest_hit_rec(s, ro, rd, win);
  }
  template <class M>
  __device__ __forceinline__ static void surface(const SceneView& s, V3 ro, V3 rd, float t, int win, V3& normal,
                                                 M& mat) {
    analytical_surface(s, ro, rd, t, win, normal, mat);
  }
  template <class A>
  __device__ __forceinline__ static void closest_hit_adj(const SceneView& s, V3 ro, V3 rd, float t, int win,
                                                         float ct_t, V3 ct_normal, const A& a, const GradSink& g,
                                                         V3& c_ro, V3& c_rd) {
    pt::closest_hit_adj(s, ro, rd, t, win, ct_t, ct_normal, a, g, c_ro, c_rd);
  }
  __device__ __forceinline__ static void background_adj(const SceneView& s, V3 rd, V3 ct, const GradSink& g,
                                                        V3& c_rd) {
    sky_background_adj(s, SV_SKY_HORIZON, rd, ct, g, c_rd);
  }
};

}  // namespace pt
