// Scalar per-thread twin of ops/intersect.py. A miss is +inf, and
// isfinite(t) is the hit signal downstream.
#pragma once

#include "vecmath.cuh"

namespace pt {

// The sphere test past l = center - ro, in double, as ops/intersect.py runs
// it: near a silhouette r^2 - d2 cancels to a few float ulps of |l|^2 and
// dt grows as 1/sqrt(r^2 - d2), so any two float orderings (FMA or not)
// would give the gradient there different digits. In double the products of
// float inputs are exact and t rounds to the same float on both sides.
struct SphereHit {
  double tca, d2, radius2, thc;
  float t;  // +inf on a miss
};

__device__ __forceinline__ SphereHit ray_sphere_hit(V3 ro, V3 rd, V3 center, float radius) {
  V3 lf = center - ro;
  SphereHit h;
  double lx = lf.x, ly = lf.y, lz = lf.z;
  h.tca = lx * (double)rd.x + ly * (double)rd.y + lz * (double)rd.z;
  h.d2 = (lx * lx + ly * ly + lz * lz) - h.tca * h.tca;
  h.radius2 = (double)radius * (double)radius;
  double x = h.radius2 - h.d2;
  h.thc = x > 0.0 ? sqrt(x) : 0.0;
  double t0 = h.tca - h.thc;
  double t = t0 < 0.0 ? h.tca + h.thc : t0;
  bool miss = (h.d2 > h.radius2) || (t < 0.0);
  h.t = miss ? INFINITY : (float)t;
  return h;
}

__device__ __forceinline__ float ray_sphere(V3 ro, V3 rd, V3 center, float radius) {
  return ray_sphere_hit(ro, rd, center, radius).t;
}

__device__ __forceinline__ float ray_rect(V3 ro, V3 rd, V3 corner, V3 u, V3 v) {
  V3 n = cross(u, v);
  float denom = dot(n, rd);
  bool facing = fabsf(denom) > 1e-8f;
  float t = dot(corner - ro, n) / (facing ? denom : 1.0f);
  V3 rel = madd3(ro, rd, t) - corner;
  float uu = dot(u, u);
  float vv = dot(v, v);
  float a = dot(rel, u) / (uu > 0.0f ? uu : 1.0f);
  float b = dot(rel, v) / (vv > 0.0f ? vv : 1.0f);
  bool ok = facing && t >= 0.0f && a >= 0.0f && a <= 1.0f && b >= 0.0f && b <= 1.0f;
  return ok ? t : INFINITY;
}

__device__ __forceinline__ float ray_plane(V3 ro, V3 rd, V3 normal, V3 point) {
  const float eps = 0.0001f;
  float denom = dot(normal, rd);
  float t = dot(point - ro, normal) / (fabsf(denom) > eps ? denom : 1.0f);
  bool miss = (fabsf(denom) <= eps) || (t < 0.0f);
  return miss ? INFINITY : t;
}

// Two-sided Möller-Trumbore (ops/intersect.ray_triangle): t > eps or +inf.
// inv_det is 0 where |det| <= eps; a hit needs u, v >= 0 and u + v <= 1.
// Every dot and cross product is unfused, in the plain version's order: a
// ray through an edge shared by two triangles picks its triangle by the
// last bits of u and v.
__device__ __forceinline__ float ray_triangle(V3 ro, V3 rd, V3 v0, V3 v1, V3 v2) {
  const float eps = 1e-7f;
  const V3 e1 = v1 - v0, e2 = v2 - v0;
  const V3 p = cross_rn(rd, e2);
  const float det = dot_rn(e1, p);
  const bool ok_det = fabsf(det) > eps;
  const float inv_det = ok_det ? 1.0f / det : 0.0f;
  const V3 s = ro - v0;
  const float u = dot_rn(s, p) * inv_det;
  const V3 q = cross_rn(s, e1);
  const float v = dot_rn(rd, q) * inv_det;
  const float t = dot_rn(e2, q) * inv_det;
  return ok_det && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > eps ? t : INFINITY;
}

}  // namespace pt
