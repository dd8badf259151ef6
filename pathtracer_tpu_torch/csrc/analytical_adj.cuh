// Reverse-mode adjoints of analytical.cuh (closest hit, background and the
// material pick), writing d(loss)/d(packed scene) through a GradSink.
#pragma once

#include "analytical.cuh"
#include "bsdf_adj.cuh"
#include "intersect_adj.cuh"

namespace pt {

// Where one thread adds its cotangents of the packed scene: entry j lives at
// g[j * stride] (the backward kernel keeps one column per thread in shared
// memory; the host build one row).
struct GradSink {
  float* g;
  int stride;
  __device__ __forceinline__ void add(int j, float v) const { g[j * stride] += v; }
  __device__ __forceinline__ void add3(int j, V3 v) const {
    add(j, v.x);
    add(j + 1, v.y);
    add(j + 2, v.z);
  }
};

// Material record offsets (analytical.cuh layout) of the fields that carry
// gradient; opacity, alpha_mode and alpha_cutoff are only compared.
enum : int {
  MAT_RGB = 0, MAT_ANISOTROPIC = 3, MAT_EMISSION = 4, MAT_METALLIC = 7, MAT_ROUGHNESS = 8, MAT_SUBSURFACE = 9,
  MAT_SPECULAR_TINT = 10, MAT_SHEEN = 11, MAT_SHEEN_TINT = 12, MAT_CLEARCOAT = 13, MAT_CLEARCOAT_GLOSS = 14,
  MAT_SPEC_TRANS = 15, MAT_IOR = 16,
};

__device__ __forceinline__ int light_offset(const SceneView& s, int i) { return SV_LIGHTS + i * LIGHT_STRIDE; }
__device__ __forceinline__ int material_offset(const SceneView& s, int i) {
  return SV_LIGHTS + s.n_lights * LIGHT_STRIDE + i * MAT_STRIDE;
}

// The record fields of a raw (un-finalized) material cotangent.
__device__ __forceinline__ void scatter_material_adj(const GradSink& g, int off, const MatAdj& a, bool with_rgb) {
  if (with_rgb) g.add3(off + MAT_RGB, a.rgb);
  g.add(off + MAT_ANISOTROPIC, a.anisotropic);
  g.add3(off + MAT_EMISSION, a.emission);
  g.add(off + MAT_METALLIC, a.metallic);
  g.add(off + MAT_ROUGHNESS, a.roughness);
  g.add(off + MAT_SUBSURFACE, a.subsurface);
  g.add(off + MAT_SPECULAR_TINT, a.specular_tint);
  g.add(off + MAT_SHEEN, a.sheen);
  g.add(off + MAT_SHEEN_TINT, a.sheen_tint);
  g.add(off + MAT_CLEARCOAT, a.clearcoat);
  g.add(off + MAT_CLEARCOAT_GLOSS, a.clearcoat_gloss);
  g.add(off + MAT_SPEC_TRANS, a.spec_trans);
  g.add(off + MAT_IOR, a.ior);
}

// Sky gradient: to_linear(mix(horizon, zenith, 0.5 (rd.y + 1))) * scale.
__device__ __forceinline__ void background_adj(const SceneView& s, V3 rd, V3 ct, const GradSink& g, V3& c_rd) {
  float t = 0.5f * (rd.y + 1.0f);
  V3 hor = load3(s.sv + SV_SKY_HORIZON), zen = load3(s.sv + SV_SKY_ZENITH);
  V3 c = mix(hor, zen, t);
  float scale = s.sv[SV_SKY_SCALE];
  g.add(SV_SKY_SCALE, dot(ct, to_linear(c)));
  V3 c_lin = ct * scale;
  V3 c_c = v3(c_lin.x * 2.2f * powf(c.x, 1.2f), c_lin.y * 2.2f * powf(c.y, 1.2f), c_lin.z * 2.2f * powf(c.z, 1.2f));
  V3 c_hor = splat3(0.0f), c_zen = splat3(0.0f);
  float c_t = 0.0f;
  mix_adj(hor, zen, t, c_c, c_hor, c_zen, c_t);
  g.add3(SV_SKY_HORIZON, c_hor);
  g.add3(SV_SKY_ZENITH, c_zen);
  c_rd.y += 0.5f * c_t;
}

// closest_hit on a ray that hits: cotangents of t, of the geometric normal
// and of the raw material record (the plane's rgb is its checker albedo).
// A tie in the closest distance shares ct_t evenly, as jnp.min does.
__device__ __forceinline__ void closest_hit_adj(const SceneView& s, V3 ro, V3 rd, float ct_t, V3 ct_normal,
                                                const MatAdj& a, const GradSink& g, V3& c_ro, V3& c_rd) {
  float t0, t1, tp;
  primitive_ts(s, ro, rd, t0, t1, tp);
  float t = fminf(fminf(t0, t1), tp);
  int idx = t == t0 ? 0 : (t == t1 ? 1 : 2);

  if (idx == 2) {
    g.add3(SV_PLANE_NORMAL, ct_normal);
  } else {
    int ci = SV_SPHERE_CENTER + (idx == 0 ? 0 : 3);
    V3 q = madd3(ro, rd, t) - load3(s.sv + ci);
    V3 c_q = safe_normalize_adj(q, ct_normal);
    g.add3(ci, -c_q);
    c_ro += c_q;
    c_rd += c_q * t;
    ct_t += dot(c_q, rd);
  }

  float ct_each = ct_t / (float)((t0 == t) + (t1 == t) + (tp == t));
  for (int k = 0; k < 2; ++k) {
    if ((k == 0 ? t0 : t1) != t) continue;
    int ci = SV_SPHERE_CENTER + 3 * k;
    V3 c_center = splat3(0.0f);
    float c_radius = 0.0f;
    ray_sphere_adj(ro, rd, load3(s.sv + ci), s.sv[SV_SPHERE_RADIUS + k], ct_each, c_ro, c_rd, c_center, c_radius);
    g.add3(ci, c_center);
    g.add(SV_SPHERE_RADIUS + k, c_radius);
  }
  if (tp == t) {
    V3 c_n = splat3(0.0f), c_p = splat3(0.0f);
    ray_plane_adj(ro, rd, load3(s.sv + SV_PLANE_NORMAL), load3(s.sv + SV_PLANE_POINT), ct_each, c_ro, c_rd, c_n,
                  c_p);
    g.add3(SV_PLANE_NORMAL, c_n);
    g.add3(SV_PLANE_POINT, c_p);
  }

  scatter_material_adj(g, material_offset(s, min(idx, s.n_materials - 1)), a, idx != 2);
  if (idx == 2) {
    float safe_dy = rd.y != 0.0f ? rd.y : 1.0f;
    float cx = rd.x / safe_dy * s.sv[SV_CHECKER_SCALE] + s.sv[SV_CHECKER_OFFSET];
    float cy = rd.z / safe_dy * s.sv[SV_CHECKER_SCALE] + s.sv[SV_CHECKER_OFFSET];
    float x1 = fmodf(floorf(cx), 2.0f);
    float y1 = fmodf(floorf(cy), 2.0f);
    g.add(SV_CHECKER_ALBEDO + (fmodf(x1 + y1, 2.0f) < 1.0f ? 0 : 1), a.rgb.x + a.rgb.y + a.rgb.z);
  }
}

}  // namespace pt
