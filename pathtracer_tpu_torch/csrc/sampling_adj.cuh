// Reverse-mode adjoints of the sampling.cuh terms that carry gradient under
// the detached-sampling estimator (the sampled directions themselves are
// constants there, so sample_* need none).
#pragma once

#include "sampling.cuh"
#include "vecmath_adj.cuh"

namespace pt {

// a^2 / (a^2 + b^2), zero when both are zero.
__device__ __forceinline__ void power_heuristic_adj(float a, float b, float ct, float& c_a, float& c_b) {
  float t = a * a;
  float denom = b * b + t;
  if (!(denom > 0.0f)) return;
  float out = t / denom;
  float c_t = ct / denom;
  float c_den = -ct * out / denom;
  c_t += c_den;
  c_b += c_den * 2.0f * b;
  c_a += c_t * 2.0f * a;
}

// clip(1 - u, 0, 1)^5.
__device__ __forceinline__ float schlick_fresnel_adj(float u, float ct) {
  float m = clampf(1.0f - u, 0.0f, 1.0f);
  float m2 = m * m;
  return -ct * 5.0f * m2 * m2 * dclip(1.0f - u, 0.0f, 1.0f);
}

__device__ __forceinline__ void dielectric_fresnel_adj(float cos_theta_i, float eta, float ct, float& c_cos,
                                                       float& c_eta) {
  float sin_theta_tsq = eta * eta * (1.0f - cos_theta_i * cos_theta_i);
  if (sin_theta_tsq > 1.0f) return;  // total internal reflection: constant 1
  float cos_t = safe_sqrt(1.0f - sin_theta_tsq);
  float denom_s = eta * cos_t + cos_theta_i;
  float denom_p = eta * cos_theta_i + cos_t;
  float ds = denom_s != 0.0f ? denom_s : 1.0f;
  float dp = denom_p != 0.0f ? denom_p : 1.0f;
  float rs = (eta * cos_t - cos_theta_i) / ds;
  float rp = (eta * cos_theta_i - cos_t) / dp;
  float c_rs = ct * rs, c_rp = ct * rp;
  float c_ns = c_rs / ds, c_np = c_rp / dp;
  float c_ds = denom_s != 0.0f ? -c_rs * rs / ds : 0.0f;
  float c_dp = denom_p != 0.0f ? -c_rp * rp / dp : 0.0f;
  float c_cos_t = 0.0f;
  // ns = eta cos_t - ci, np = eta ci - cos_t, ds = eta cos_t + ci, dp = eta ci + cos_t
  c_eta += (c_ns + c_ds) * cos_t + (c_np + c_dp) * cos_theta_i;
  c_cos_t += (c_ns + c_ds) * eta - c_np + c_dp;
  c_cos += -c_ns + c_ds + (c_np + c_dp) * eta;
  float c_s = -safe_sqrt_adj(1.0f - sin_theta_tsq, c_cos_t);
  c_eta += c_s * 2.0f * eta * (1.0f - cos_theta_i * cos_theta_i);
  c_cos += c_s * eta * eta * (-2.0f * cos_theta_i);
}

// GTR1: (a2 - 1) / (pi log2(a2) (1 + (a2 - 1) ndoth^2)), 1/pi for a >= 1.
__device__ __forceinline__ void gtr1_adj(float ndoth, float a, float ct, float& c_ndoth, float& c_a) {
  if (a >= 1.0f) return;
  float a2 = a * a;
  float t = 1.0f + (a2 - 1.0f) * ndoth * ndoth;
  float lg = log2f(a2);
  float denom = PI * lg * t;
  float dn = denom != 0.0f ? denom : 1.0f;
  float val = (a2 - 1.0f) / dn;
  float c_a2 = ct / dn;
  float c_den = denom != 0.0f ? -ct * val / denom : 0.0f;
  float c_lg = c_den * PI * t;
  float c_t = c_den * PI * lg;
  c_a2 += c_lg / (a2 * 0.693147180559945309f);
  c_a2 += c_t * ndoth * ndoth;
  c_ndoth += c_t * (a2 - 1.0f) * 2.0f * ndoth;
  c_a += c_a2 * 2.0f * a;
}

// Smith G1, isotropic, with alphag a constant.
__device__ __forceinline__ float smithg_adj(float ndotv, float alphag, float ct) {
  float a = alphag * alphag;
  float b = ndotv * ndotv;
  float x = a + b - a * b;
  float denom = ndotv + safe_sqrt(x);
  float dn = denom != 0.0f ? denom : 1.0f;
  float out = (2.0f * ndotv) / dn;
  float c_nv = 2.0f * ct / dn;
  float c_den = denom != 0.0f ? -ct * out / denom : 0.0f;
  c_nv += c_den;
  c_nv += safe_sqrt_adj(x, c_den) * (1.0f - a) * 2.0f * ndotv;
  return c_nv;
}

__device__ __forceinline__ void gtr2_aniso_adj(float ndoth, float hdotx, float hdoty, float ax, float ay, float ct,
                                               float& c_ndoth, float& c_hdotx, float& c_hdoty, float& c_ax,
                                               float& c_ay) {
  float a = hdotx / ax;
  float b = hdoty / ay;
  float c = a * a + b * b + ndoth * ndoth;
  float denom = PI * ax * ay * c * c;
  if (denom == 0.0f) return;
  float out = 1.0f / denom;
  float c_den = -ct * out * out;
  c_ax += c_den * PI * ay * c * c;
  c_ay += c_den * PI * ax * c * c;
  float c_c = c_den * PI * ax * ay * 2.0f * c;
  float c_a = c_c * 2.0f * a, c_b = c_c * 2.0f * b;
  c_ndoth += c_c * 2.0f * ndoth;
  c_hdotx += c_a / ax;
  c_ax -= c_a * a / ax;
  c_hdoty += c_b / ay;
  c_ay -= c_b * b / ay;
}

// hg_phase(cos, g) = (1 - g^2) / (4 pi denom^1.5), denom = 1 + g^2 - 2 g cos,
// with the forward's unfused products, so denom is the forward's.
__device__ __forceinline__ void hg_phase_adj(float cos_theta, float g, float ct, float& c_cos, float& c_g) {
  float g2 = __fmul_rn(g, g);
  float denom = __fadd_rn(1.0f, g2) - __fmul_rn(__fmul_rn(2.0f, g), cos_theta);
  float num = INV_PI * 0.25f * (1.0f - g2);
  float root = safe_sqrt(denom);
  float den = denom * root;
  float c_num = ct / den;
  float c_den = -ct * (num / den) / den;
  float c_denom = c_den * root + safe_sqrt_adj(denom, c_den * denom);
  float c_g2 = -c_num * (INV_PI * 0.25f) + c_denom;
  c_cos += c_denom * (-2.0f * g);
  c_g += c_denom * (-2.0f * cos_theta) + c_g2 * 2.0f * g;
}

__device__ __forceinline__ void smithg_aniso_adj(float ndotv, float vdotx, float vdoty, float ax, float ay, float ct,
                                                 float& c_ndotv, float& c_vdotx, float& c_vdoty, float& c_ax,
                                                 float& c_ay) {
  float a = vdotx * ax;
  float b = vdoty * ay;
  float c = ndotv;
  float x = a * a + b * b + c * c;
  float denom = ndotv + safe_sqrt(x);
  float dn = denom != 0.0f ? denom : 1.0f;
  float out = (2.0f * ndotv) / dn;
  c_ndotv += 2.0f * ct / dn;
  float c_den = denom != 0.0f ? -ct * out / denom : 0.0f;
  c_ndotv += c_den;
  float c_x = safe_sqrt_adj(x, c_den);
  float c_a = c_x * 2.0f * a, c_b = c_x * 2.0f * b;
  c_ndotv += c_x * 2.0f * c;
  c_vdotx += c_a * ax;
  c_ax += c_a * vdotx;
  c_vdoty += c_b * ay;
  c_ay += c_b * vdoty;
}

}  // namespace pt
