// Scalar per-thread twin of models/material.py (finalize_material) and
// ops/bsdf.py (disney_sample, disney_eval). The Python code computes every
// lobe on every lane and selects; here each thread branches to the lobe it
// needs, which gives the same value for that lobe.
//
// Kept verbatim: the stale prev_l Fresnel in disney_sample, and
// guard_div's zero at exactly grazing incidence (0/0 would leak NaN).
#pragma once

#include "sampling.cuh"

namespace pt {

struct Material {
  V3 rgb;
  float anisotropic;
  V3 emission;
  float metallic, roughness, subsurface, specular_tint;
  float sheen, sheen_tint, clearcoat, clearcoat_gloss, clearcoat_roughness;
  float spec_trans, ior, opacity;
  int alpha_mode;
  float alpha_cutoff, ax, ay;
};

// Material::new.
__device__ __forceinline__ Material default_material() {
  Material m;
  m.rgb = splat3(1.5f);
  m.anisotropic = 0.0f;
  m.emission = splat3(0.0f);
  m.metallic = 0.0f;
  m.roughness = 0.5f;
  m.subsurface = 0.0f;
  m.specular_tint = 0.0f;
  m.sheen = 0.0f;
  m.sheen_tint = 0.0f;
  m.clearcoat = 0.0f;
  m.clearcoat_gloss = 0.0f;
  m.clearcoat_roughness = 0.0f;
  m.spec_trans = 0.0f;
  m.ior = 1.45f;
  m.opacity = 1.0f;
  m.alpha_mode = 0;
  m.alpha_cutoff = 0.0f;
  m.ax = 0.0f;
  m.ay = 0.0f;
  return m;
}

__device__ __forceinline__ void finalize_material(Material& m) {
  m.roughness = fmaxf(m.roughness, 0.01f);
  m.clearcoat_roughness = mix_f(0.1f, 0.001f, m.clearcoat_gloss);
  float aspect = sqrtf(1.0f - m.anisotropic * 0.9f);
  m.ax = fmaxf(m.roughness / aspect, 0.001f);
  m.ay = fmaxf(m.roughness * aspect, 0.001f);
}

__device__ __forceinline__ float guard_div(float a, float b, bool mask) {
  return (mask && b != 0.0f) ? a / b : 0.0f;
}

__device__ __forceinline__ void get_spec_color(const Material& m, float eta, V3& spec_col, V3& sheen_col) {
  float lum = luminance(m.rgb);
  V3 white = splat3(1.0f);
  V3 ctint = lum > 0.0f ? m.rgb / splat3(lum) : white;
  float f0 = (1.0f - eta) / (1.0f + eta);
  spec_col = mix(mix(white, ctint, m.specular_tint) * (f0 * f0), m.rgb, m.metallic);
  sheen_col = mix(white, ctint, m.sheen_tint);
}

__device__ __forceinline__ float disney_fresnel(const Material& m, float eta, float ldoth, float vdoth) {
  float metallic_f = schlick_fresnel(ldoth);
  float dielectric_f = dielectric_fresnel(fabsf(vdoth), eta);
  return mix_f(dielectric_f, metallic_f, m.metallic);
}

struct LobeWeights {
  float diffuse, spec_reflect, spec_refract, clearcoat;
};

__device__ __forceinline__ LobeWeights get_lobe_probabilities(const Material& m, V3 spec_col, float approx_fresnel) {
  float diffuse_wt = luminance(m.rgb) * (1.0f - m.metallic) * (1.0f - m.spec_trans);
  float spec_reflect_wt = luminance(mix(spec_col, splat3(1.0f), approx_fresnel));
  float spec_refract_wt = (1.0f - approx_fresnel) * (1.0f - m.metallic) * m.spec_trans * luminance(m.rgb);
  float clearcoat_wt = 0.25f * m.clearcoat * (1.0f - m.metallic);
  float total = diffuse_wt + spec_reflect_wt + spec_refract_wt + clearcoat_wt;
  float inv = guard_div(1.0f, total, total > 0.0f);
  return {diffuse_wt * inv, spec_reflect_wt * inv, spec_refract_wt * inv, clearcoat_wt * inv};
}

// Each eval_* works in the local frame (n = +z) and returns f; pdf by reference.
__device__ __forceinline__ V3 eval_diffuse(const Material& m, V3 c_sheen, V3 v, V3 l, V3 h, float& pdf) {
  if (!(l.z > 0.0f)) {
    pdf = 0.0f;
    return splat3(0.0f);
  }
  float ldoth = dot(l, h);
  float fl = schlick_fresnel(l.z);
  float fv = schlick_fresnel(v.z);
  float fh = schlick_fresnel(ldoth);
  float fd90 = 0.5f + 2.0f * ldoth * ldoth * m.roughness;
  float fd = mix_f(1.0f, fd90, fl) * mix_f(1.0f, fd90, fv);
  float fss90 = ldoth * ldoth * m.roughness;
  float fss = mix_f(1.0f, fss90, fl) * mix_f(1.0f, fss90, fv);
  float inv_lzvz = guard_div(1.0f, l.z + v.z, true);
  float ss = 1.25f * (fss * (inv_lzvz - 0.5f) + 0.5f);
  V3 fsheen = c_sheen * (fh * m.sheen);
  pdf = l.z * INV_PI;
  return (m.rgb * (INV_PI * mix_f(fd, ss, m.subsurface)) + fsheen) *
         ((1.0f - m.metallic) * (1.0f - m.spec_trans));
}

__device__ __forceinline__ V3 eval_spec_reflection(const Material& m, float eta, V3 spec_col, V3 v, V3 l, V3 h,
                                                   float& pdf) {
  if (!(l.z > 0.0f)) {
    pdf = 0.0f;
    return splat3(0.0f);
  }
  float fm = disney_fresnel(m, eta, dot(l, h), dot(v, h));
  V3 f_col = mix(spec_col, splat3(1.0f), fm);
  float d = gtr2_aniso(h.z, h.x, h.y, m.ax, m.ay);
  float g1 = smithg_aniso(fabsf(v.z), v.x, v.y, m.ax, m.ay);
  float g2 = g1 * smithg_aniso(fabsf(l.z), l.x, l.y, m.ax, m.ay);
  pdf = guard_div(g1 * d, 4.0f * v.z, true);
  float scale = guard_div(d * g2, 4.0f * l.z * v.z, true);
  return f_col * scale;
}

__device__ __forceinline__ V3 eval_spec_refraction(const Material& m, float eta, V3 v, V3 l, V3 h, float& pdf) {
  if (!(l.z < 0.0f)) {
    pdf = 0.0f;
    return splat3(0.0f);
  }
  float vdoth = dot(v, h);
  float ldoth = dot(l, h);
  float f = dielectric_fresnel(fabsf(vdoth), eta);
  float d = gtr2_aniso(h.z, h.x, h.y, m.ax, m.ay);
  float g1 = smithg_aniso(fabsf(v.z), v.x, v.y, m.ax, m.ay);
  float g2 = g1 * smithg_aniso(fabsf(l.z), l.x, l.y, m.ax, m.ay);
  float denom = ldoth + vdoth * eta;
  denom = denom * denom;
  float eta2 = eta * eta;
  float jacobian = guard_div(fabsf(ldoth), denom, true);
  pdf = guard_div(g1 * fmaxf(vdoth, 0.0f) * d * jacobian, v.z, true);
  float scale = (1.0f - m.metallic) * m.spec_trans * (1.0f - f) * d * g2 * fabsf(vdoth) * jacobian * eta2;
  scale = guard_div(scale, fabsf(l.z * v.z), true);
  return v3(safe_sqrt(m.rgb.x), safe_sqrt(m.rgb.y), safe_sqrt(m.rgb.z)) * scale;
}

__device__ __forceinline__ V3 eval_clearcoat(const Material& m, V3 v, V3 l, V3 h, float& pdf) {
  if (!(l.z > 0.0f)) {
    pdf = 0.0f;
    return splat3(0.0f);
  }
  float vdoth = dot(v, h);
  float fh = dielectric_fresnel(vdoth, 1.0f / 1.5f);
  float f_scalar = mix_f(0.04f, 1.0f, fh);
  float d = gtr1(h.z, m.clearcoat_roughness);
  float g = smithg(l.z, 0.25f) * smithg(v.z, 0.25f);
  float jacobian = guard_div(1.0f, 4.0f * vdoth, true);
  pdf = d * h.z * jacobian;
  float scale = guard_div(m.clearcoat * f_scalar * d * g, 4.0f * l.z * v.z, true);
  return splat3(scale * 0.25f);
}

struct BsdfSample {
  V3 l;  // world direction
  V3 f;  // |n.l| * bsdf
  float pdf;
};

// Importance-sample the Disney BSDF. v_world = -ray direction, n_world the
// front-facing normal, prev_l the previous bounce's sampled direction.
__device__ __forceinline__ BsdfSample disney_sample(const Material& m, float eta, V3 v_world, V3 n_world,
                                                    V3 prev_l, float r1, float r2, float u_coin) {
  V3 t, b;
  onb(n_world, t, b);
  V3 v = to_local(t, b, n_world, v_world);

  V3 spec_col, sheen_col;
  get_spec_color(m, eta, spec_col, sheen_col);
  float approx_fresnel = disney_fresnel(m, eta, v.z, v.z);
  LobeWeights w = get_lobe_probabilities(m, spec_col, approx_fresnel);

  // Lobe CDF order [diffuse, +clearcoat, +spec_reflect, +spec_refract].
  float cdf0 = w.diffuse;
  float cdf1 = cdf0 + w.clearcoat;
  V3 l, f;
  float pdf;
  if (r1 < cdf0) {
    float r1_d = clampf(guard_div(r1, cdf0, cdf0 > 0.0f), 0.0f, 1.0f);
    l = cosine_sample_hemisphere(r1_d, r2);
    V3 h = safe_normalize(l + v);
    f = eval_diffuse(m, sheen_col, v, l, h, pdf);
    pdf = pdf * w.diffuse;
  } else if (r1 < cdf1) {
    float span_c = cdf1 - cdf0;
    float r1_c = clampf(guard_div(r1 - cdf0, span_c, span_c > 0.0f), 0.0f, 1.0f);
    V3 h = sample_gtr1(m.clearcoat_roughness, r1_c);
    if (h.z < 0.0f) h = -h;
    l = safe_normalize(reflect(-v, h));
    f = eval_clearcoat(m, v, l, h, pdf);
    pdf = pdf * w.clearcoat;
  } else {
    float span_s = 1.0f - cdf1;
    float r1_s = clampf(guard_div(r1 - cdf1, span_s, span_s > 0.0f), 0.0f, 1.0f);
    V3 h = sample_ggxvndf(v, m.ax, m.ay, r1_s, r2);
    if (h.z < 0.0f) h = -h;
    // Stale-l Fresnel: world-space prev_l against the local half vector.
    float fresnel = disney_fresnel(m, eta, dot(prev_l, h), dot(v, h));
    float ff = 1.0f - ((1.0f - fresnel) * m.spec_trans * (1.0f - m.metallic));
    if (u_coin < ff) {
      l = safe_normalize(reflect(-v, h));
      f = eval_spec_reflection(m, eta, spec_col, v, l, h, pdf);
      pdf = pdf * ff;
    } else {
      l = safe_normalize(refract(-v, h, eta));
      f = eval_spec_refraction(m, eta, v, l, h, pdf);
      pdf = pdf * (1.0f - ff);
    }
    pdf = pdf * (w.spec_reflect + w.spec_refract);
  }
  BsdfSample s;
  s.l = to_world(t, b, n_world, l);
  s.f = f * fabsf(dot(n_world, s.l));
  s.pdf = pdf;
  return s;
}

// Full BSDF value (|l.z| * bsdf) and pdf for a given world direction.
__device__ __forceinline__ V3 disney_eval(const Material& m, float eta, V3 v_world, V3 n_world, V3 l_world,
                                          float& bsdf_pdf) {
  V3 t, b;
  onb(n_world, t, b);
  V3 v = to_local(t, b, n_world, v_world);
  V3 l = to_local(t, b, n_world, l_world);

  V3 h = l.z > 0.0f ? safe_normalize(l + v) : safe_normalize(l + v * eta);
  if (h.z < 0.0f) h = -h;

  V3 spec_col, sheen_col;
  get_spec_color(m, eta, spec_col, sheen_col);
  float fresnel = disney_fresnel(m, eta, dot(l, h), dot(v, h));
  LobeWeights w = get_lobe_probabilities(m, spec_col, fresnel);

  V3 f = splat3(0.0f);
  bsdf_pdf = 0.0f;
  float p;
  if (w.diffuse > 0.0f && l.z > 0.0f) {
    f = f + eval_diffuse(m, sheen_col, v, l, h, p);
    bsdf_pdf = bsdf_pdf + p * w.diffuse;
  }
  if (w.spec_reflect > 0.0f && l.z > 0.0f && v.z > 0.0f) {
    f = f + eval_spec_reflection(m, eta, spec_col, v, l, h, p);
    bsdf_pdf = bsdf_pdf + p * w.spec_reflect;
  }
  if (w.spec_refract > 0.0f && l.z < 0.0f) {
    f = f + eval_spec_refraction(m, eta, v, l, h, p);
    bsdf_pdf = bsdf_pdf + p * w.spec_refract;
  }
  if (w.clearcoat > 0.0f && l.z > 0.0f && v.z > 0.0f) {
    f = f + eval_clearcoat(m, v, l, h, p);
    bsdf_pdf = bsdf_pdf + p * w.clearcoat;
  }
  return f * fabsf(l.z);
}

}  // namespace pt
