// Reverse-mode adjoints of intersect.cuh, for a ray that hits (a miss is
// +inf behind a select, so its cotangent is zero and callers skip it).
#pragma once

#include "intersect.cuh"
#include "vecmath_adj.cuh"

namespace pt {

// t = tca -/+ safe_sqrt(r^2 - d2), tca = l.rd, d2 = |l|^2 - tca^2, l = c - ro;
// in double past l, as the forward (1/thc is large at a silhouette, and
// d/dl = 2 c_d2 (l - tca rd) + ct rd cancels).
__device__ __forceinline__ void ray_sphere_adj(V3 ro, V3 rd, V3 center, float radius, float ct, V3& c_ro, V3& c_rd,
                                               V3& c_center, float& c_radius) {
  const SphereHit h = ray_sphere_hit(ro, rd, center, radius);
  const V3 l = center - ro;
  double sgn = (h.tca - h.thc) < 0.0 ? 1.0 : -1.0;  // t1 = tca + thc, else t0 = tca - thc
  double c_x = h.radius2 - h.d2 > 0.0 ? sgn * (double)ct * 0.5 / h.thc : 0.0;
  c_radius += (float)(c_x * 2.0 * (double)radius);
  double c_d2 = -c_x;
  double c_tca = (double)ct - 2.0 * h.tca * c_d2;
  V3 c_l = v3((float)((double)l.x * (2.0 * c_d2) + (double)rd.x * c_tca),
              (float)((double)l.y * (2.0 * c_d2) + (double)rd.y * c_tca),
              (float)((double)l.z * (2.0 * c_d2) + (double)rd.z * c_tca));
  c_rd += v3((float)((double)l.x * c_tca), (float)((double)l.y * c_tca), (float)((double)l.z * c_tca));
  c_center += c_l;
  c_ro -= c_l;
}

// t = ((point - ro).normal) / (normal.rd).
__device__ __forceinline__ void ray_plane_adj(V3 ro, V3 rd, V3 normal, V3 point, float ct, V3& c_ro, V3& c_rd,
                                              V3& c_normal, V3& c_point) {
  float denom = dot(normal, rd);
  V3 rel = point - ro;
  float t = dot(rel, normal) / denom;
  float c_num = ct / denom;
  float c_den = -ct * t / denom;
  c_normal += rd * c_den + rel * c_num;
  c_rd += normal * c_den;
  c_point += normal * c_num;
  c_ro -= normal * c_num;
}

// t = ((corner - ro).n) / (n.rd), n = u x v; the in-quad tests carry none.
__device__ __forceinline__ void ray_rect_adj(V3 ro, V3 rd, V3 corner, V3 u, V3 v, float ct, V3& c_ro, V3& c_rd,
                                             V3& c_corner, V3& c_u, V3& c_v) {
  V3 n = cross(u, v);
  V3 c_n = splat3(0.0f);
  ray_plane_adj(ro, rd, n, corner, ct, c_ro, c_rd, c_n, c_corner);
  cross_adj(u, v, c_n, c_u, c_v);
}

}  // namespace pt
