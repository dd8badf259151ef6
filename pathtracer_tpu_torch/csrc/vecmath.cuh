// Scalar per-thread twin of ops/vecmath.py.
#pragma once

#include <math.h>
#include <stdint.h>

namespace pt {

// Python doubles rounded to float, as the JAX/torch code applies them.
constexpr float PI = 3.14159265358979323846f;
constexpr float TWO_PI = 6.28318530717958647692f;
constexpr float INV_PI = 0.318309886183790671538f;

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 v3(float x, float y, float z) { return {x, y, z}; }
__device__ __forceinline__ V3 splat3(float a) { return {a, a, a}; }

__device__ __forceinline__ V3 operator+(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V3 operator-(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V3 operator*(V3 a, V3 b) { return {a.x * b.x, a.y * b.y, a.z * b.z}; }
__device__ __forceinline__ V3 operator/(V3 a, V3 b) { return {a.x / b.x, a.y / b.y, a.z / b.z}; }
__device__ __forceinline__ V3 operator+(V3 a, float s) { return {a.x + s, a.y + s, a.z + s}; }
__device__ __forceinline__ V3 operator-(V3 a, float s) { return {a.x - s, a.y - s, a.z - s}; }
__device__ __forceinline__ V3 operator*(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
__device__ __forceinline__ V3 operator*(float s, V3 a) { return {a.x * s, a.y * s, a.z * s}; }
__device__ __forceinline__ V3 operator/(V3 a, float s) { return {a.x / s, a.y / s, a.z / s}; }
__device__ __forceinline__ V3 operator-(V3 a) { return {-a.x, -a.y, -a.z}; }

__device__ __forceinline__ V3 select3(bool c, V3 a, V3 b) { return c ? a : b; }

// a + b * s with the product and the sum rounded apart, never fused into an
// FMA, as the plain version's two tensor ops round it. Ray points and the
// origins of the next rays go through it: a silhouette hit's gradient
// depends on the last bit of the ray (intersect.cuh).
__device__ __forceinline__ V3 madd3(V3 a, V3 b, float s) {
  return {__fadd_rn(a.x, __fmul_rn(b.x, s)), __fadd_rn(a.y, __fmul_rn(b.y, s)), __fadd_rn(a.z, __fmul_rn(b.z, s))};
}

__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }

// The products of a dot and a cross product rounded apart from their sums
// (never contracted into an FMA), in the plain version's order: where a
// decision hangs on their last bit (the SDF march, a triangle's edge) the
// kernel rounds as the separate tensor ops do.
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float dot_rn(V3 a, V3 b) { return mul_rn(a.x, b.x) + mul_rn(a.y, b.y) + mul_rn(a.z, b.z); }
__device__ __forceinline__ V3 cross_rn(V3 a, V3 b) {
  return {mul_rn(a.y, b.z) - mul_rn(a.z, b.y), mul_rn(a.z, b.x) - mul_rn(a.x, b.z),
          mul_rn(a.x, b.y) - mul_rn(a.y, b.x)};
}
// safe_normalize over dot_rn.
__device__ __forceinline__ V3 safe_normalize_rn(V3 a) {
  float l2 = dot_rn(a, a);
  float inv = l2 > 0.0f ? 1.0f / sqrtf(l2) : 0.0f;
  return a * inv;
}

__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}

__device__ __forceinline__ float length(V3 a) { return sqrtf(dot(a, a)); }

// a / |a|, three divisions (not a reciprocal multiply), as vecmath.normalize.
__device__ __forceinline__ V3 normalize(V3 a) { return a / length(a); }

__device__ __forceinline__ float safe_sqrt(float x) { return x > 0.0f ? sqrtf(x) : 0.0f; }

__device__ __forceinline__ V3 safe_normalize(V3 a) {
  float l2 = dot(a, a);
  float inv = l2 > 0.0f ? 1.0f / sqrtf(l2) : 0.0f;
  return a * inv;
}

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ V3 mix(V3 a, V3 b, float t) { return a * (1.0f - t) + b * t; }
__device__ __forceinline__ float mix_f(float a, float b, float t) { return (1.0f - t) * a + b * t; }

__device__ __forceinline__ V3 reflect(V3 i, V3 n) { return i - (n * 2.0f) * splat3(dot(n, i)); }

// GLSL refract; zero on total internal reflection.
__device__ __forceinline__ V3 refract(V3 i, V3 n, float eta) {
  float ndoti = dot(n, i);
  float k = 1.0f - eta * eta * (1.0f - ndoti * ndoti);
  V3 out = i * eta - n * (eta * ndoti + safe_sqrt(k));
  return k < 0.0f ? splat3(0.0f) : out;
}

// Orthonormal basis around n: up = +z unless |n.z| >= 0.999, then +x.
__device__ __forceinline__ void onb(V3 n, V3& t, V3& b) {
  bool cond = fabsf(n.z) < 0.999f;
  V3 up = v3(cond ? 0.0f : 1.0f, 0.0f, cond ? 1.0f : 0.0f);
  t = safe_normalize(cross(up, n));
  b = cross(n, t);
}

__device__ __forceinline__ V3 to_local(V3 t, V3 b, V3 n, V3 v) { return v3(dot(v, t), dot(v, b), dot(v, n)); }
__device__ __forceinline__ V3 to_world(V3 t, V3 b, V3 n, V3 v) { return t * v.x + b * v.y + n * v.z; }

__device__ __forceinline__ float luminance(V3 c) {
  return 0.212671f * c.x + 0.715160f * c.y + 0.072169f * c.z;
}

__device__ __forceinline__ V3 to_linear(V3 c) {
  return v3(powf(c.x, 2.2f), powf(c.y, 2.2f), powf(c.z, 2.2f));
}

}  // namespace pt
