// Reverse-mode adjoints of bsdf.cuh under the detached-sampling estimator:
// disney_eval (the NEE side: f and pdf differentiable in the material, eta,
// v and the frame; the light direction is a constant) and disney_sample
// (f and the world direction differentiable through v and the frame; the
// local direction, half vector and pdf are constants).
#pragma once

#include "bsdf.cuh"
#include "sampling_adj.cuh"

namespace pt {

// Cotangents of a Material's float fields (alpha fields carry none).
struct MatAdj {
  V3 rgb, emission;
  float anisotropic, metallic, roughness, subsurface, specular_tint;
  float sheen, sheen_tint, clearcoat, clearcoat_gloss, clearcoat_roughness;
  float spec_trans, ior, ax, ay;
};

__device__ __forceinline__ MatAdj zero_mat_adj() {
  MatAdj a;
  a.rgb = splat3(0.0f);
  a.emission = splat3(0.0f);
  a.anisotropic = a.metallic = a.roughness = a.subsurface = a.specular_tint = 0.0f;
  a.sheen = a.sheen_tint = a.clearcoat = a.clearcoat_gloss = a.clearcoat_roughness = 0.0f;
  a.spec_trans = a.ior = a.ax = a.ay = 0.0f;
  return a;
}

// finalize_material: moves the cotangents of the derived fields
// (roughness, clearcoat_roughness, ax, ay) onto the raw record fields
// (roughness, clearcoat_gloss, anisotropic). `raw` is the record before
// finalize_material.
__device__ __forceinline__ void finalize_material_adj(const Material& raw, MatAdj& a) {
  float rf = fmaxf(raw.roughness, 0.01f);
  float aspect = sqrtf(1.0f - raw.anisotropic * 0.9f);
  float c_axr = a.ax * dmax(rf / aspect, 0.001f);
  float c_ayr = a.ay * dmax(rf * aspect, 0.001f);
  float c_rf = a.roughness + c_axr / aspect + c_ayr * aspect;
  float c_aspect = -c_axr * rf / (aspect * aspect) + c_ayr * rf;
  a.anisotropic += c_aspect * (0.5f / aspect) * -0.9f;
  a.roughness = c_rf * dmax(raw.roughness, 0.01f);
  a.clearcoat_gloss += a.clearcoat_roughness * (0.001f - 0.1f);
  a.clearcoat_roughness = 0.0f;
  a.ax = a.ay = 0.0f;
}

__device__ __forceinline__ void get_spec_color_adj(const Material& m, float eta, V3 c_spec, V3 c_sheen, MatAdj& a,
                                                   float& c_eta) {
  float lum = luminance(m.rgb);
  V3 white = splat3(1.0f);
  bool pos = lum > 0.0f;
  V3 ctint = pos ? m.rgb / splat3(lum) : white;
  float f0 = (1.0f - eta) / (1.0f + eta);
  V3 inner = mix(white, ctint, m.specular_tint);
  V3 sc = inner * (f0 * f0);
  // spec = mix(sc, rgb, metallic)
  V3 c_sc = splat3(0.0f), c_ctint = splat3(0.0f), c_white = splat3(0.0f);
  mix_adj(sc, m.rgb, m.metallic, c_spec, c_sc, a.rgb, a.metallic);
  V3 c_inner = c_sc * (f0 * f0);
  float c_f0 = dot(c_sc, inner) * 2.0f * f0;
  c_eta += c_f0 * (-2.0f / ((1.0f + eta) * (1.0f + eta)));
  mix_adj(white, ctint, m.specular_tint, c_inner, c_white, c_ctint, a.specular_tint);
  mix_adj(white, ctint, m.sheen_tint, c_sheen, c_white, c_ctint, a.sheen_tint);
  if (pos) {
    a.rgb += c_ctint / splat3(lum);
    a.rgb += luminance_adj(-dot(c_ctint, m.rgb) / (lum * lum));
  }
}

// mix_f(dielectric(|vdoth|, eta), schlick(ldoth), metallic).
__device__ __forceinline__ void disney_fresnel_adj(const Material& m, float eta, float ldoth, float vdoth, float ct,
                                                   MatAdj& a, float& c_eta, float& c_ldoth, float& c_vdoth) {
  float sch = schlick_fresnel(ldoth);
  float die = dielectric_fresnel(fabsf(vdoth), eta);
  a.metallic += ct * (sch - die);
  c_ldoth += schlick_fresnel_adj(ldoth, ct * m.metallic);
  float c_abs = 0.0f;
  dielectric_fresnel_adj(fabsf(vdoth), eta, ct * (1.0f - m.metallic), c_abs, c_eta);
  c_vdoth += c_abs * signf(vdoth);
}

// ct[4]: cotangents of the normalized (diffuse, spec_reflect, spec_refract,
// clearcoat) weights.
__device__ __forceinline__ void get_lobe_probabilities_adj(const Material& m, V3 spec_col, float af, const float ct[4],
                                                           MatAdj& a, V3& c_spec, float& c_af) {
  float lum = luminance(m.rgb);
  V3 white = splat3(1.0f);
  V3 mx = mix(spec_col, white, af);
  float raw[4] = {lum * (1.0f - m.metallic) * (1.0f - m.spec_trans), luminance(mx),
                  (1.0f - af) * (1.0f - m.metallic) * m.spec_trans * lum, 0.25f * m.clearcoat * (1.0f - m.metallic)};
  float total = raw[0] + raw[1] + raw[2] + raw[3];
  float inv = guard_div(1.0f, total, total > 0.0f);
  float c_inv = 0.0f, c_raw[4];
  for (int k = 0; k < 4; ++k) {
    c_raw[k] = ct[k] * inv;
    c_inv += ct[k] * raw[k];
  }
  if (total > 0.0f) {
    float c_total = -c_inv * inv * inv;
    for (int k = 0; k < 4; ++k) c_raw[k] += c_total;
  }
  float c_lum = 0.0f;
  // diffuse: lum (1 - metallic) (1 - spec_trans)
  c_lum += c_raw[0] * (1.0f - m.metallic) * (1.0f - m.spec_trans);
  a.metallic -= c_raw[0] * lum * (1.0f - m.spec_trans);
  a.spec_trans -= c_raw[0] * lum * (1.0f - m.metallic);
  // spec_reflect: lum(mix(spec_col, white, af))
  V3 c_white = splat3(0.0f);
  mix_adj(spec_col, white, af, luminance_adj(c_raw[1]), c_spec, c_white, c_af);
  // spec_refract: (1 - af) (1 - metallic) spec_trans lum
  c_af -= c_raw[2] * (1.0f - m.metallic) * m.spec_trans * lum;
  a.metallic -= c_raw[2] * (1.0f - af) * m.spec_trans * lum;
  a.spec_trans += c_raw[2] * (1.0f - af) * (1.0f - m.metallic) * lum;
  c_lum += c_raw[2] * (1.0f - af) * (1.0f - m.metallic) * m.spec_trans;
  // clearcoat: 0.25 clearcoat (1 - metallic)
  a.clearcoat += c_raw[3] * 0.25f * (1.0f - m.metallic);
  a.metallic -= c_raw[3] * 0.25f * m.clearcoat;
  a.rgb += luminance_adj(c_lum);
}

// Cotangents of a lobe's local-frame inputs.
struct LobeAdj {
  V3 v, l, h, spec_col, sheen_col;
  float eta;
};

__device__ __forceinline__ LobeAdj zero_lobe_adj() {
  LobeAdj a;
  a.v = a.l = a.h = a.spec_col = a.sheen_col = splat3(0.0f);
  a.eta = 0.0f;
  return a;
}

// x = mix_f(1, f90, fa) mix_f(1, f90, fb).
__device__ __forceinline__ void mix_pair_adj(float f90, float fa, float fb, float ct, float& c_f90, float& c_fa,
                                             float& c_fb) {
  float A = mix_f(1.0f, f90, fa), B = mix_f(1.0f, f90, fb);
  float c_A = ct * B, c_B = ct * A;
  c_f90 += c_A * fa + c_B * fb;
  c_fa += c_A * (f90 - 1.0f);
  c_fb += c_B * (f90 - 1.0f);
}

__device__ __forceinline__ void eval_diffuse_adj(const Material& m, V3 c_sheen, V3 v, V3 l, V3 h, V3 ct_f,
                                                 float ct_pdf, MatAdj& a, LobeAdj& la) {
  if (!(l.z > 0.0f)) return;
  float ldoth = dot(l, h);
  float fl = schlick_fresnel(l.z);
  float fv = schlick_fresnel(v.z);
  float fh = schlick_fresnel(ldoth);
  float fd90 = 0.5f + 2.0f * ldoth * ldoth * m.roughness;
  float fd = mix_f(1.0f, fd90, fl) * mix_f(1.0f, fd90, fv);
  float fss90 = ldoth * ldoth * m.roughness;
  float fss = mix_f(1.0f, fss90, fl) * mix_f(1.0f, fss90, fv);
  float sum_z = l.z + v.z;
  float inv_lzvz = guard_div(1.0f, sum_z, true);
  float ss = 1.25f * (fss * (inv_lzvz - 0.5f) + 0.5f);
  float M = mix_f(fd, ss, m.subsurface);
  V3 A = m.rgb * (INV_PI * M) + c_sheen * (fh * m.sheen);
  float K = (1.0f - m.metallic) * (1.0f - m.spec_trans);

  V3 c_A = ct_f * K;
  float c_K = dot(ct_f, A);
  a.metallic -= c_K * (1.0f - m.spec_trans);
  a.spec_trans -= c_K * (1.0f - m.metallic);
  a.rgb += c_A * (INV_PI * M);
  float c_M = dot(c_A, m.rgb) * INV_PI;
  la.sheen_col += c_A * (fh * m.sheen);
  float c_fhs = dot(c_A, c_sheen);
  float c_fh = c_fhs * m.sheen;
  a.sheen += c_fhs * fh;
  float c_fd = c_M * (1.0f - m.subsurface);
  float c_ss = c_M * m.subsurface;
  a.subsurface += c_M * (ss - fd);
  float c_fss = c_ss * 1.25f * (inv_lzvz - 0.5f);
  float c_inv = c_ss * 1.25f * fss;
  if (sum_z != 0.0f) {
    float c_sum = -c_inv * inv_lzvz * inv_lzvz;
    la.l.z += c_sum;
    la.v.z += c_sum;
  }
  float c_fss90 = 0.0f, c_fd90 = 0.0f, c_fl = 0.0f, c_fv = 0.0f;
  mix_pair_adj(fss90, fl, fv, c_fss, c_fss90, c_fl, c_fv);
  mix_pair_adj(fd90, fl, fv, c_fd, c_fd90, c_fl, c_fv);
  float c_ldoth = c_fd90 * 4.0f * ldoth * m.roughness + c_fss90 * 2.0f * ldoth * m.roughness;
  a.roughness += c_fd90 * 2.0f * ldoth * ldoth + c_fss90 * ldoth * ldoth;
  c_ldoth += schlick_fresnel_adj(ldoth, c_fh);
  la.l.z += schlick_fresnel_adj(l.z, c_fl) + ct_pdf * INV_PI;
  la.v.z += schlick_fresnel_adj(v.z, c_fv);
  la.l += h * c_ldoth;
  la.h += l * c_ldoth;
}

__device__ __forceinline__ void eval_spec_reflection_adj(const Material& m, float eta, V3 spec_col, V3 v, V3 l, V3 h,
                                                         V3 ct_f, float ct_pdf, MatAdj& a, LobeAdj& la) {
  if (!(l.z > 0.0f)) return;
  float ldoth = dot(l, h), vdoth = dot(v, h);
  float fm = disney_fresnel(m, eta, ldoth, vdoth);
  V3 f_col = mix(spec_col, splat3(1.0f), fm);
  float d = gtr2_aniso(h.z, h.x, h.y, m.ax, m.ay);
  float g1 = smithg_aniso(fabsf(v.z), v.x, v.y, m.ax, m.ay);
  float gl = smithg_aniso(fabsf(l.z), l.x, l.y, m.ax, m.ay);
  float g2 = g1 * gl;
  float den_s = 4.0f * l.z * v.z;
  float scale = guard_div(d * g2, den_s, true);
  float den_p = 4.0f * v.z;
  float pdf = guard_div(g1 * d, den_p, true);

  V3 c_fcol = ct_f * scale;
  float c_scale = dot(ct_f, f_col);
  float c_d = 0.0f, c_g1 = 0.0f, c_g2 = 0.0f;
  if (den_s != 0.0f) {
    float c_num = c_scale / den_s;
    float c_den = -c_scale * scale / den_s;
    c_d += c_num * g2;
    c_g2 += c_num * d;
    la.l.z += c_den * 4.0f * v.z;
    la.v.z += c_den * 4.0f * l.z;
  }
  if (den_p != 0.0f) {
    float c_num = ct_pdf / den_p;
    c_g1 += c_num * d;
    c_d += c_num * g1;
    la.v.z += -ct_pdf * pdf / den_p * 4.0f;
  }
  c_g1 += c_g2 * gl;
  float c_gl = c_g2 * g1;
  float c_abs = 0.0f;
  smithg_aniso_adj(fabsf(l.z), l.x, l.y, m.ax, m.ay, c_gl, c_abs, la.l.x, la.l.y, a.ax, a.ay);
  la.l.z += c_abs * signf(l.z);
  c_abs = 0.0f;
  smithg_aniso_adj(fabsf(v.z), v.x, v.y, m.ax, m.ay, c_g1, c_abs, la.v.x, la.v.y, a.ax, a.ay);
  la.v.z += c_abs * signf(v.z);
  gtr2_aniso_adj(h.z, h.x, h.y, m.ax, m.ay, c_d, la.h.z, la.h.x, la.h.y, a.ax, a.ay);
  float c_fm = 0.0f;
  V3 c_white = splat3(0.0f);
  mix_adj(spec_col, splat3(1.0f), fm, c_fcol, la.spec_col, c_white, c_fm);
  float c_ldoth = 0.0f, c_vdoth = 0.0f;
  disney_fresnel_adj(m, eta, ldoth, vdoth, c_fm, a, la.eta, c_ldoth, c_vdoth);
  la.l += h * c_ldoth;
  la.h += l * c_ldoth + v * c_vdoth;
  la.v += h * c_vdoth;
}

// d(prod_i x_i)/dx_k for n <= 8 factors without dividing by any of them.
__device__ __forceinline__ void product_partials(const float* x, int n, float* out) {
  float pre = 1.0f;
  for (int k = 0; k < n; ++k) {
    out[k] = pre;
    pre *= x[k];
  }
  float suf = 1.0f;
  for (int k = n - 1; k >= 0; --k) {
    out[k] *= suf;
    suf *= x[k];
  }
}

__device__ __forceinline__ void eval_spec_refraction_adj(const Material& m, float eta, V3 v, V3 l, V3 h, V3 ct_f,
                                                         float ct_pdf, MatAdj& a, LobeAdj& la) {
  if (!(l.z < 0.0f)) return;
  float vdoth = dot(v, h);
  float ldoth = dot(l, h);
  float F = dielectric_fresnel(fabsf(vdoth), eta);
  float d = gtr2_aniso(h.z, h.x, h.y, m.ax, m.ay);
  float g1 = smithg_aniso(fabsf(v.z), v.x, v.y, m.ax, m.ay);
  float gl = smithg_aniso(fabsf(l.z), l.x, l.y, m.ax, m.ay);
  float g2 = g1 * gl;
  float u = ldoth + vdoth * eta;
  float den = u * u;
  float eta2 = eta * eta;
  float jac = guard_div(fabsf(ldoth), den, true);
  float mv = fmaxf(vdoth, 0.0f);
  float s_fac[8] = {1.0f - m.metallic, m.spec_trans, 1.0f - F, d, g2, fabsf(vdoth), jac, eta2};
  float s0 = s_fac[0] * s_fac[1] * s_fac[2] * s_fac[3] * s_fac[4] * s_fac[5] * s_fac[6] * s_fac[7];
  float q = fabsf(l.z * v.z);
  float scale = guard_div(s0, q, true);
  V3 srgb = v3(safe_sqrt(m.rgb.x), safe_sqrt(m.rgb.y), safe_sqrt(m.rgb.z));

  // f = sqrt(rgb) * scale
  float c_scale = dot(ct_f, srgb);
  a.rgb += v3(safe_sqrt_adj(m.rgb.x, ct_f.x * scale), safe_sqrt_adj(m.rgb.y, ct_f.y * scale),
              safe_sqrt_adj(m.rgb.z, ct_f.z * scale));
  float c_s[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  if (q != 0.0f) {
    float c_s0 = c_scale / q;
    float c_q = -c_scale * scale / q;
    float c_lzvz = c_q * signf(l.z * v.z);
    la.l.z += c_lzvz * v.z;
    la.v.z += c_lzvz * l.z;
    float part[8];
    product_partials(s_fac, 8, part);
    for (int k = 0; k < 8; ++k) c_s[k] = c_s0 * part[k];
  }
  // pdf = guard_div(g1 max(vdoth, 0) d jac, v.z)
  float c_g1 = 0.0f, c_mv = 0.0f, c_d = c_s[3], c_jac = c_s[6];
  if (v.z != 0.0f) {
    float p_fac[4] = {g1, mv, d, jac}, part[4];
    product_partials(p_fac, 4, part);
    float c_num = ct_pdf / v.z;
    float pdf = (g1 * mv * d * jac) / v.z;
    c_g1 += c_num * part[0];
    c_mv += c_num * part[1];
    c_d += c_num * part[2];
    c_jac += c_num * part[3];
    la.v.z += -ct_pdf * pdf / v.z;
  }
  a.metallic -= c_s[0];
  a.spec_trans += c_s[1];
  float c_F = -c_s[2];
  float c_g2 = c_s[4];
  float c_vdoth = c_s[5] * signf(vdoth) + c_mv * dmax(vdoth, 0.0f);
  float c_ldoth = 0.0f;
  la.eta += c_s[7] * 2.0f * eta;
  if (den != 0.0f) {
    c_ldoth += c_jac / den * signf(ldoth);
    float c_den = -c_jac * jac / den;
    float c_u = c_den * 2.0f * u;
    c_ldoth += c_u;
    c_vdoth += c_u * eta;
    la.eta += c_u * vdoth;
  }
  c_g1 += c_g2 * gl;
  float c_gl = c_g2 * g1;
  float c_abs = 0.0f;
  smithg_aniso_adj(fabsf(l.z), l.x, l.y, m.ax, m.ay, c_gl, c_abs, la.l.x, la.l.y, a.ax, a.ay);
  la.l.z += c_abs * signf(l.z);
  c_abs = 0.0f;
  smithg_aniso_adj(fabsf(v.z), v.x, v.y, m.ax, m.ay, c_g1, c_abs, la.v.x, la.v.y, a.ax, a.ay);
  la.v.z += c_abs * signf(v.z);
  gtr2_aniso_adj(h.z, h.x, h.y, m.ax, m.ay, c_d, la.h.z, la.h.x, la.h.y, a.ax, a.ay);
  c_abs = 0.0f;
  dielectric_fresnel_adj(fabsf(vdoth), eta, c_F, c_abs, la.eta);
  c_vdoth += c_abs * signf(vdoth);
  la.v += h * c_vdoth;
  la.l += h * c_ldoth;
  la.h += v * c_vdoth + l * c_ldoth;
}

__device__ __forceinline__ void eval_clearcoat_adj(const Material& m, V3 v, V3 l, V3 h, V3 ct_f, float ct_pdf,
                                                   MatAdj& a, LobeAdj& la) {
  if (!(l.z > 0.0f)) return;
  float vdoth = dot(v, h);
  float fh = dielectric_fresnel(vdoth, 1.0f / 1.5f);
  float f_scalar = mix_f(0.04f, 1.0f, fh);
  float d = gtr1(h.z, m.clearcoat_roughness);
  float sl = smithg(l.z, 0.25f), sv = smithg(v.z, 0.25f);
  float g = sl * sv;
  float den_j = 4.0f * vdoth;
  float jac = guard_div(1.0f, den_j, true);
  float den_s = 4.0f * l.z * v.z;
  float scale = guard_div(m.clearcoat * f_scalar * d * g, den_s, true);

  float c_scale = 0.25f * (ct_f.x + ct_f.y + ct_f.z);
  float c_fs = 0.0f, c_d = 0.0f, c_g = 0.0f, c_vdoth = 0.0f, c_hz = 0.0f;
  if (den_s != 0.0f) {
    float c_n = c_scale / den_s;
    a.clearcoat += c_n * f_scalar * d * g;
    c_fs += c_n * m.clearcoat * d * g;
    c_d += c_n * m.clearcoat * f_scalar * g;
    c_g += c_n * m.clearcoat * f_scalar * d;
    float c_den = -c_scale * scale / den_s;
    la.l.z += c_den * 4.0f * v.z;
    la.v.z += c_den * 4.0f * l.z;
  }
  // pdf = d h.z jac
  c_d += ct_pdf * h.z * jac;
  c_hz += ct_pdf * d * jac;
  float c_jac = ct_pdf * d * h.z;
  if (den_j != 0.0f) c_vdoth += -c_jac * jac * jac * 4.0f;
  la.l.z += smithg_adj(l.z, 0.25f, c_g * sv);
  la.v.z += smithg_adj(v.z, 0.25f, c_g * sl);
  gtr1_adj(h.z, m.clearcoat_roughness, c_d, c_hz, a.clearcoat_roughness);
  float c_fh = c_fs * (1.0f - 0.04f);
  float c_eta = 0.0f;
  dielectric_fresnel_adj(vdoth, 1.0f / 1.5f, c_fh, c_vdoth, c_eta);
  la.v += h * c_vdoth;
  la.h += v * c_vdoth;
  la.h.z += c_hz;
}

// The NEE side: cotangents (ct_f of f = |l.z| bsdf, ct_pdf) -> material,
// eta, v_world and n_world; l_world is a constant. The forward runs once:
// cot(f, pdf, ct_f&, ct_pdf&) sees what disney_eval returns (f and its
// pdf, in its arithmetic) and sets the cotangents, or returns false for
// none (the adjoint is then skipped).
template <class Cot>
__device__ __forceinline__ void disney_eval_with_adj(const Material& m, float eta, V3 v_world, V3 n_world,
                                                     V3 l_world, Cot cot, MatAdj& a, float& c_eta, V3& c_vw,
                                                     V3& c_nw) {
  V3 t, b;
  onb(n_world, t, b);
  V3 v = to_local(t, b, n_world, v_world);
  V3 l = to_local(t, b, n_world, l_world);
  bool upper = l.z > 0.0f;
  V3 hraw = upper ? l + v : l + v * eta;
  V3 h = safe_normalize(hraw);
  bool flip = h.z < 0.0f;
  if (flip) h = -h;
  V3 spec_col, sheen_col;
  get_spec_color(m, eta, spec_col, sheen_col);
  float ldoth = dot(l, h), vdoth = dot(v, h);
  float fresnel = disney_fresnel(m, eta, ldoth, vdoth);
  LobeWeights w = get_lobe_probabilities(m, spec_col, fresnel);

  // Forward sum of f (for the |l.z| factor), then each active lobe's adjoint.
  V3 f = splat3(0.0f);
  float p;
  bool on_d = w.diffuse > 0.0f && l.z > 0.0f;
  bool on_r = w.spec_reflect > 0.0f && l.z > 0.0f && v.z > 0.0f;
  bool on_t = w.spec_refract > 0.0f && l.z < 0.0f;
  bool on_c = w.clearcoat > 0.0f && l.z > 0.0f && v.z > 0.0f;
  float pd = 0.0f, pr = 0.0f, pt_ = 0.0f, pc = 0.0f, bsdf_pdf = 0.0f;
  if (on_d) {
    f = f + eval_diffuse(m, sheen_col, v, l, h, pd);
    bsdf_pdf = bsdf_pdf + pd * w.diffuse;
  }
  if (on_r) {
    f = f + eval_spec_reflection(m, eta, spec_col, v, l, h, pr);
    bsdf_pdf = bsdf_pdf + pr * w.spec_reflect;
  }
  if (on_t) {
    f = f + eval_spec_refraction(m, eta, v, l, h, pt_);
    bsdf_pdf = bsdf_pdf + pt_ * w.spec_refract;
  }
  if (on_c) {
    f = f + eval_clearcoat(m, v, l, h, pc);
    bsdf_pdf = bsdf_pdf + pc * w.clearcoat;
  }
  (void)p;
  V3 ct_f;
  float ct_pdf;
  if (!cot(f * fabsf(l.z), bsdf_pdf, ct_f, ct_pdf)) return;

  LobeAdj la = zero_lobe_adj();
  V3 c_fsum = ct_f * fabsf(l.z);
  la.l.z += dot(ct_f, f) * signf(l.z);
  float c_w[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (on_d) {
    eval_diffuse_adj(m, sheen_col, v, l, h, c_fsum, ct_pdf * w.diffuse, a, la);
    c_w[0] = ct_pdf * pd;
  }
  if (on_r) {
    eval_spec_reflection_adj(m, eta, spec_col, v, l, h, c_fsum, ct_pdf * w.spec_reflect, a, la);
    c_w[1] = ct_pdf * pr;
  }
  if (on_t) {
    eval_spec_refraction_adj(m, eta, v, l, h, c_fsum, ct_pdf * w.spec_refract, a, la);
    c_w[2] = ct_pdf * pt_;
  }
  if (on_c) {
    eval_clearcoat_adj(m, v, l, h, c_fsum, ct_pdf * w.clearcoat, a, la);
    c_w[3] = ct_pdf * pc;
  }
  float c_fr = 0.0f;
  get_lobe_probabilities_adj(m, spec_col, fresnel, c_w, a, la.spec_col, c_fr);
  float c_ldoth = 0.0f, c_vdoth = 0.0f;
  disney_fresnel_adj(m, eta, ldoth, vdoth, c_fr, a, la.eta, c_ldoth, c_vdoth);
  la.l += h * c_ldoth;
  la.v += h * c_vdoth;
  la.h += l * c_ldoth + v * c_vdoth;
  get_spec_color_adj(m, eta, la.spec_col, la.sheen_col, a, la.eta);
  V3 c_h0 = flip ? -la.h : la.h;
  V3 c_hraw = safe_normalize_adj(hraw, c_h0);
  la.l += c_hraw;
  if (upper) {
    la.v += c_hraw;
  } else {
    la.v += c_hraw * eta;
    la.eta += dot(c_hraw, v);
  }
  c_eta += la.eta;
  V3 c_t = splat3(0.0f), c_b = splat3(0.0f), c_lw = splat3(0.0f);
  to_local_adj(t, b, n_world, l_world, la.l, c_t, c_b, c_nw, c_lw);
  to_local_adj(t, b, n_world, v_world, la.v, c_t, c_b, c_nw, c_vw);
  onb_adj(n_world, c_t, c_b, c_nw);
}

// The sampled side: cotangents of the world direction bs.l (c_lw) and of
// bs.f (ct_f) -> material, eta, v_world and n_world. Replays disney_sample
// to find the lobe, the local direction and the half vector (constants),
// once: cot(bs, c_lw&, ct_f&) sees the sample disney_sample returns (in its
// arithmetic) and sets the cotangents, or returns false for none (the
// adjoint is then skipped).
template <class Cot>
__device__ __forceinline__ void disney_sample_with_adj(const Material& m, float eta, V3 v_world, V3 n_world,
                                                       V3 prev_l, float r1, float r2, float u_coin, Cot cot,
                                                       MatAdj& a, float& c_eta, V3& c_vw, V3& c_nw) {
  V3 t, b;
  onb(n_world, t, b);
  V3 v = to_local(t, b, n_world, v_world);
  V3 spec_col, sheen_col;
  get_spec_color(m, eta, spec_col, sheen_col);
  float approx_fresnel = disney_fresnel(m, eta, v.z, v.z);
  LobeWeights w = get_lobe_probabilities(m, spec_col, approx_fresnel);
  float cdf0 = w.diffuse;
  float cdf1 = cdf0 + w.clearcoat;
  int lobe;  // 0 diffuse, 1 clearcoat, 2 spec reflection, 3 spec refraction
  V3 l, h, f;
  float pdf;
  if (r1 < cdf0) {
    lobe = 0;
    float r1_d = clampf(guard_div(r1, cdf0, cdf0 > 0.0f), 0.0f, 1.0f);
    l = cosine_sample_hemisphere(r1_d, r2);
    h = safe_normalize(l + v);
    f = eval_diffuse(m, sheen_col, v, l, h, pdf);
    pdf = pdf * w.diffuse;
  } else if (r1 < cdf1) {
    lobe = 1;
    float span_c = cdf1 - cdf0;
    float r1_c = clampf(guard_div(r1 - cdf0, span_c, span_c > 0.0f), 0.0f, 1.0f);
    h = sample_gtr1(m.clearcoat_roughness, r1_c);
    if (h.z < 0.0f) h = -h;
    l = safe_normalize(reflect(-v, h));
    f = eval_clearcoat(m, v, l, h, pdf);
    pdf = pdf * w.clearcoat;
  } else {
    float span_s = 1.0f - cdf1;
    float r1_s = clampf(guard_div(r1 - cdf1, span_s, span_s > 0.0f), 0.0f, 1.0f);
    h = sample_ggxvndf(v, m.ax, m.ay, r1_s, r2);
    if (h.z < 0.0f) h = -h;
    float fresnel = disney_fresnel(m, eta, dot(prev_l, h), dot(v, h));
    float ff = 1.0f - ((1.0f - fresnel) * m.spec_trans * (1.0f - m.metallic));
    if (u_coin < ff) {
      lobe = 2;
      l = safe_normalize(reflect(-v, h));
      f = eval_spec_reflection(m, eta, spec_col, v, l, h, pdf);
      pdf = pdf * ff;
    } else {
      lobe = 3;
      l = safe_normalize(refract(-v, h, eta));
      f = eval_spec_refraction(m, eta, v, l, h, pdf);
      pdf = pdf * (1.0f - ff);
    }
    pdf = pdf * (w.spec_reflect + w.spec_refract);
  }
  V3 lw = to_world(t, b, n_world, l);
  float cosw = dot(n_world, lw);
  BsdfSample bs;
  bs.l = lw;
  bs.f = f * fabsf(cosw);
  bs.pdf = pdf;
  V3 c_lw, ct_f;
  if (!cot(bs, c_lw, ct_f)) return;

  // f_out = f |n.lw|; lw = to_world(t, b, n, l) with l constant.
  V3 c_f = ct_f * fabsf(cosw);
  float c_cos = dot(ct_f, f) * signf(cosw);
  c_nw += lw * c_cos;
  V3 c_lw_total = c_lw + n_world * c_cos;
  V3 c_t = splat3(0.0f), c_b = splat3(0.0f), c_l = splat3(0.0f);
  to_world_adj(t, b, n_world, l, c_lw_total, c_t, c_b, c_nw, c_l);

  LobeAdj la = zero_lobe_adj();
  if (lobe == 0) eval_diffuse_adj(m, sheen_col, v, l, h, c_f, 0.0f, a, la);
  if (lobe == 1) eval_clearcoat_adj(m, v, l, h, c_f, 0.0f, a, la);
  if (lobe == 2) eval_spec_reflection_adj(m, eta, spec_col, v, l, h, c_f, 0.0f, a, la);
  if (lobe == 3) eval_spec_refraction_adj(m, eta, v, l, h, c_f, 0.0f, a, la);
  get_spec_color_adj(m, eta, la.spec_col, la.sheen_col, a, la.eta);
  c_eta += la.eta;
  to_local_adj(t, b, n_world, v_world, la.v, c_t, c_b, c_nw, c_vw);
  onb_adj(n_world, c_t, c_b, c_nw);
}

}  // namespace pt
