// Scalar per-thread twin of ops/sampling.py (the parts the forward path
// runs). Every division keeps the Python code's zero-denominator guard.
// The Henyey-Greenstein terms round every product apart from the sums it
// feeds (__fmul_rn), in the plain version's order: sample_hg's cos divides
// a difference of nearly equal terms by 2g, where an FMA's last bit is
// magnified at small |g|.
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

// Henyey-Greenstein phase p(cos; g), normalized over the sphere; cos is
// between the propagation and the scattered direction (g > 0 forward).
__device__ __forceinline__ float hg_phase(float cos_theta, float g) {
  float g2 = __fmul_rn(g, g);
  float denom = __fadd_rn(1.0f, g2) - __fmul_rn(__fmul_rn(2.0f, g), cos_theta);
  return INV_PI * 0.25f * (1.0f - g2) / (denom * safe_sqrt(denom));
}

// Importance-samples hg_phase about the unit direction d (its pdf is
// hg_phase); |g| < 1e-3 samples the uniform sphere.
__device__ __forceinline__ V3 sample_hg(V3 d, float g, float r1, float r2) {
  bool iso = fabsf(g) < 1e-3f;
  float gs = iso ? 0.5f : g;
  float g2 = __fmul_rn(gs, gs);
  float sqr = (1.0f - g2) / (__fadd_rn(1.0f, gs) - __fmul_rn(__fmul_rn(2.0f, gs), r2));
  float cos_aniso = (__fadd_rn(1.0f, g2) - __fmul_rn(sqr, sqr)) / (2.0f * gs);
  float cos_theta = clampf(iso ? 1.0f - __fmul_rn(2.0f, r2) : cos_aniso, -1.0f, 1.0f);
  float sin_theta = safe_sqrt(1.0f - __fmul_rn(cos_theta, cos_theta));
  float phi = TWO_PI * r1;
  V3 t, b;
  onb(d, t, b);
  return to_world(t, b, d, v3(sin_theta * cosf(phi), sin_theta * sinf(phi), cos_theta));
}

}  // namespace pt
