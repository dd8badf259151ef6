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

// Two-sided Möller-Trumbore's t past its guards (ray_triangle on a hit):
// t = <e2, q> inv_det, inv_det = 1 / det, det = <e1, p>, p = rd x e2,
// q = s x e1, s = ro - v0, e1 = v1 - v0, e2 = v2 - v0. u and v only gate,
// so they carry no cotangent; v0 is reached through e1, e2 and s, v1
// through e1, v2 through e2, ro through s, rd through p. The forward values
// are ray_triangle's, unfused; the adjoint itself may round freely.
__device__ __forceinline__ void ray_triangle_adj(V3 ro, V3 rd, V3 v0, V3 v1, V3 v2, float ct, V3& c_ro, V3& c_rd,
                                                 V3& c_v0, V3& c_v1, V3& c_v2) {
  const V3 e1 = v1 - v0, e2 = v2 - v0;
  const V3 p = cross_rn(rd, e2);
  const float inv_det = 1.0f / dot_rn(e1, p);
  const V3 s = ro - v0;
  const V3 q = cross_rn(s, e1);
  const float c_num = ct * inv_det;                            // d t / d <e2, q>
  const float c_det = -ct * dot_rn(e2, q) * inv_det * inv_det;  // d t / d det
  V3 c_e1 = p * c_det, c_e2 = q * c_num, c_s = splat3(0.0f);
  cross_adj(s, e1, e2 * c_num, c_s, c_e1);
  cross_adj(rd, e2, e1 * c_det, c_rd, c_e2);
  c_ro += c_s;
  c_v1 += c_e1;
  c_v2 += c_e2;
  c_v0 -= c_s + c_e1 + c_e2;
}

}  // namespace pt
