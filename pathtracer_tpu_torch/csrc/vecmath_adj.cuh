// Reverse-mode adjoints of vecmath.cuh. Convention for every *_adj in the
// adjoint headers: the primal inputs come first, then the cotangent of the
// output(s); the cotangents of the differentiable inputs are ADDED to the
// reference arguments named c_<input>. Each adjoint recomputes the forward
// values it needs. Guards mirror the plain version's double-where forms:
// a masked branch contributes an exact zero, never 0 * inf.
#pragma once

#include "vecmath.cuh"

namespace pt {

constexpr float LUM_R = 0.212671f, LUM_G = 0.715160f, LUM_B = 0.072169f;

__device__ __forceinline__ V3& operator+=(V3& a, V3 b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  return a;
}
__device__ __forceinline__ V3& operator-=(V3& a, V3 b) {
  a.x -= b.x;
  a.y -= b.y;
  a.z -= b.z;
  return a;
}

__device__ __forceinline__ float signf(float x) { return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f); }

// d/dx of jnp.maximum(x, c) / jnp.minimum(x, c): a tie sends half the
// gradient to each operand.
__device__ __forceinline__ float dmax(float x, float c) { return x > c ? 1.0f : (x == c ? 0.5f : 0.0f); }
__device__ __forceinline__ float dmin(float x, float c) { return x < c ? 1.0f : (x == c ? 0.5f : 0.0f); }
// d/dx of jnp.clip(x, lo, hi) = minimum(maximum(x, lo), hi).
__device__ __forceinline__ float dclip(float x, float lo, float hi) { return dmax(x, lo) * dmin(fmaxf(x, lo), hi); }

__device__ __forceinline__ void dot_adj(V3 a, V3 b, float ct, V3& c_a, V3& c_b) {
  c_a += b * ct;
  c_b += a * ct;
}

// c = a x b: <ct, da x b> = <da, b x ct>, <ct, a x db> = <db, ct x a>.
__device__ __forceinline__ void cross_adj(V3 a, V3 b, V3 ct, V3& c_a, V3& c_b) {
  c_a += cross(b, ct);
  c_b += cross(ct, a);
}

// a / |a| (the three-division normalize).
__device__ __forceinline__ V3 normalize_adj(V3 a, V3 ct) {
  float l = length(a);
  V3 n = a / l;
  return (ct - n * dot(n, ct)) / splat3(l);
}

// a * rsqrt(|a|^2), zero (and zero cotangent) for a zero vector.
__device__ __forceinline__ V3 safe_normalize_adj(V3 a, V3 ct) {
  float l2 = dot(a, a);
  if (!(l2 > 0.0f)) return splat3(0.0f);
  float inv = 1.0f / sqrtf(l2);
  return ct * inv - a * (inv * inv * inv * dot(a, ct));
}

__device__ __forceinline__ float safe_sqrt_adj(float x, float ct) { return x > 0.0f ? ct * 0.5f / sqrtf(x) : 0.0f; }

// onb(n) -> (t, b): t = safe_normalize(up x n), b = n x t, up constant.
__device__ __forceinline__ void onb_adj(V3 n, V3 ct_t, V3 ct_b, V3& c_n) {
  bool cond = fabsf(n.z) < 0.999f;
  V3 up = v3(cond ? 0.0f : 1.0f, 0.0f, cond ? 1.0f : 0.0f);
  V3 c = cross(up, n);
  V3 t = safe_normalize(c);
  V3 c_t = ct_t;
  cross_adj(n, t, ct_b, c_n, c_t);
  V3 c_c = safe_normalize_adj(c, c_t);
  V3 c_up = splat3(0.0f);
  cross_adj(up, n, c_c, c_up, c_n);
}

// to_local(t, b, n, v) = (v.t, v.b, v.n).
__device__ __forceinline__ void to_local_adj(V3 t, V3 b, V3 n, V3 v, V3 ct, V3& c_t, V3& c_b, V3& c_n, V3& c_v) {
  c_v += t * ct.x + b * ct.y + n * ct.z;
  c_t += v * ct.x;
  c_b += v * ct.y;
  c_n += v * ct.z;
}

// to_world(t, b, n, v) = t v.x + b v.y + n v.z.
__device__ __forceinline__ void to_world_adj(V3 t, V3 b, V3 n, V3 v, V3 ct, V3& c_t, V3& c_b, V3& c_n, V3& c_v) {
  c_t += ct * v.x;
  c_b += ct * v.y;
  c_n += ct * v.z;
  c_v += v3(dot(ct, t), dot(ct, b), dot(ct, n));
}

__device__ __forceinline__ V3 luminance_adj(float ct) { return v3(LUM_R * ct, LUM_G * ct, LUM_B * ct); }

// mix(a, b, t) = a (1 - t) + b t, t scalar.
__device__ __forceinline__ void mix_adj(V3 a, V3 b, float t, V3 ct, V3& c_a, V3& c_b, float& c_t) {
  c_a += ct * (1.0f - t);
  c_b += ct * t;
  c_t += dot(ct, b) - dot(ct, a);
}

}  // namespace pt
