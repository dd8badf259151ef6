// Scalar per-thread twin of ops/intersect.py. A miss is +inf, and
// isfinite(t) is the hit signal downstream.
#pragma once

#include "vecmath.cuh"

namespace pt {

__device__ __forceinline__ float ray_sphere(V3 ro, V3 rd, V3 center, float radius) {
  V3 l = center - ro;
  float tca = dot(l, rd);
  float d2 = dot(l, l) - tca * tca;
  float radius2 = radius * radius;
  float thc = safe_sqrt(radius2 - d2);
  float t0 = tca - thc;
  float t1 = tca + thc;
  float t = t0 < 0.0f ? t1 : t0;
  bool miss = (d2 > radius2) || (t < 0.0f);
  return miss ? INFINITY : t;
}

__device__ __forceinline__ float ray_rect(V3 ro, V3 rd, V3 corner, V3 u, V3 v) {
  V3 n = cross(u, v);
  float denom = dot(n, rd);
  bool facing = fabsf(denom) > 1e-8f;
  float t = dot(corner - ro, n) / (facing ? denom : 1.0f);
  V3 rel = (ro + rd * t) - corner;
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

}  // namespace pt
