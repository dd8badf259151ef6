// Scalar per-thread twin of ops/sampling.py (the parts the forward path
// runs). Every division keeps the Python code's zero-denominator guard.
#pragma once

#include "vecmath.cuh"

namespace pt {

__device__ __forceinline__ float power_heuristic(float a, float b) {
  float t = a * a;
  float denom = b * b + t;
  return denom > 0.0f ? t / denom : 0.0f;
}

__device__ __forceinline__ float schlick_fresnel(float u) {
  float m = clampf(1.0f - u, 0.0f, 1.0f);
  float m2 = m * m;
  return m2 * m2 * m;
}

__device__ __forceinline__ float dielectric_fresnel(float cos_theta_i, float eta) {
  float sin_theta_tsq = eta * eta * (1.0f - cos_theta_i * cos_theta_i);
  float cos_theta_t = safe_sqrt(1.0f - sin_theta_tsq);
  float denom_s = eta * cos_theta_t + cos_theta_i;
  float denom_p = eta * cos_theta_i + cos_theta_t;
  float rs = (eta * cos_theta_t - cos_theta_i) / (denom_s != 0.0f ? denom_s : 1.0f);
  float rp = (eta * cos_theta_i - cos_theta_t) / (denom_p != 0.0f ? denom_p : 1.0f);
  float f = 0.5f * (rs * rs + rp * rp);
  return sin_theta_tsq > 1.0f ? 1.0f : f;
}

// Clearcoat GTR1 with the reference's log2 (natural log in the GLSL original).
__device__ __forceinline__ float gtr1(float ndoth, float a) {
  float a2 = a * a;
  float t = 1.0f + (a2 - 1.0f) * ndoth * ndoth;
  float denom = PI * log2f(a2) * t;
  float val = (a2 - 1.0f) / (denom != 0.0f ? denom : 1.0f);
  return a >= 1.0f ? INV_PI : val;
}

// GTR1 half vector; phi is driven by r1 (the reference ignores r2).
__device__ __forceinline__ V3 sample_gtr1(float rgh, float r1) {
  float a = fmaxf(0.001f, rgh);
  float a2 = a * a;
  float phi = r1 * TWO_PI;
  float cos_theta = safe_sqrt((1.0f - powf(a2, 1.0f - r1)) / (1.0f - a2));
  float sin_theta = clampf(safe_sqrt(1.0f - cos_theta * cos_theta), 0.0f, 1.0f);
  return v3(sin_theta * cosf(phi), sin_theta * sinf(phi), cos_theta);
}

// Visible-normal GGX sampling (Heitz 2018).
__device__ __forceinline__ V3 sample_ggxvndf(V3 v, float ax, float ay, float r1, float r2) {
  V3 vh = safe_normalize(v3(ax * v.x, ay * v.y, v.z));
  float lensq = vh.x * vh.x + vh.y * vh.y;
  float inv_len = 1.0f / sqrtf(lensq > 0.0f ? lensq : 1.0f);
  V3 t1v = v3(lensq > 0.0f ? -vh.y * inv_len : 1.0f, lensq > 0.0f ? vh.x * inv_len : 0.0f, 0.0f);
  V3 t2v = cross(vh, t1v);

  float r = sqrtf(r1);
  float phi = TWO_PI * r2;
  float t1 = r * cosf(phi);
  float t2 = r * sinf(phi);
  float s = 0.5f * (1.0f + vh.z);
  t2 = (1.0f - s) * safe_sqrt(1.0f - t1 * t1) + s * t2;

  V3 nh = t1v * t1 + t2v * t2 + vh * safe_sqrt(1.0f - t1 * t1 - t2 * t2);
  return safe_normalize(v3(ax * nh.x, ay * nh.y, fmaxf(nh.z, 0.0f)));
}

__device__ __forceinline__ float smithg(float ndotv, float alphag) {
  float a = alphag * alphag;
  float b = ndotv * ndotv;
  float denom = ndotv + safe_sqrt(a + b - a * b);
  return (2.0f * ndotv) / (denom != 0.0f ? denom : 1.0f);
}

__device__ __forceinline__ float gtr2_aniso(float ndoth, float hdotx, float hdoty, float ax, float ay) {
  float a = hdotx / ax;
  float b = hdoty / ay;
  float c = a * a + b * b + ndoth * ndoth;
  float denom = PI * ax * ay * c * c;
  return 1.0f / (denom != 0.0f ? denom : 1.0f);
}

__device__ __forceinline__ float smithg_aniso(float ndotv, float vdotx, float vdoty, float ax, float ay) {
  float a = vdotx * ax;
  float b = vdoty * ay;
  float c = ndotv;
  float denom = ndotv + safe_sqrt(a * a + b * b + c * c);
  return (2.0f * ndotv) / (denom != 0.0f ? denom : 1.0f);
}

__device__ __forceinline__ V3 cosine_sample_hemisphere(float r1, float r2) {
  float r = sqrtf(r1);
  float phi = TWO_PI * r2;
  float x = r * cosf(phi);
  float y = r * sinf(phi);
  return v3(x, y, safe_sqrt(1.0f - x * x - y * y));
}

// Uniform hemisphere about +z; r1 is cos(theta).
__device__ __forceinline__ V3 uniform_sample_hemisphere(float r1, float r2) {
  float r = safe_sqrt(1.0f - r1 * r1);
  float phi = TWO_PI * r2;
  return v3(r * cosf(phi), r * sinf(phi), r1);
}

}  // namespace pt
