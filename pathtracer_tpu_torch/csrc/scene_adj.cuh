// The backend-neutral part of K2's adjoint: where a thread adds its
// cotangents of the packed scene (GradSink), the light and material record
// offsets of scene.cuh's layout, the material record's scatter (of 20, or of
// 26 with the medium's cotangents in the media instantiation: MediaMatAdj),
// and the sky's adjoint at a backend's sky record.
#pragma once

#include "bsdf_adj.cuh"
#include "scene.cuh"

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

// Material record offsets of the fields that carry gradient; opacity,
// alpha_mode and alpha_cutoff are only compared.
enum : int {
  MAT_RGB = 0, MAT_ANISOTROPIC = 3, MAT_EMISSION = 4, MAT_METALLIC = 7, MAT_ROUGHNESS = 8, MAT_SUBSURFACE = 9,
  MAT_SPECULAR_TINT = 10, MAT_SHEEN = 11, MAT_SHEEN_TINT = 12, MAT_CLEARCOAT = 13, MAT_CLEARCOAT_GLOSS = 14,
  MAT_SPEC_TRANS = 15, MAT_IOR = 16,
};

// The medium's fields of a 26-scalar record; the type (20) takes none.
enum : int { MAT_MEDIUM_DENSITY = 21, MAT_MEDIUM_COLOR = 22, MAT_MEDIUM_ANISO = 25 };

// The cotangents of a medium's floats.
struct MediumAdj {
  float density;
  V3 color;
  float aniso;
};

__device__ __forceinline__ MediumAdj zero_medium_adj() { return {0.0f, splat3(0.0f), 0.0f}; }

// A raw material's cotangent with its medium's, as the media
// instantiation's closest_hit_adj scatters it into a 26-scalar record.
struct MediaMatAdj : MatAdj {
  MediumAdj medium;
};

__device__ __forceinline__ MediaMatAdj zero_media_mat_adj() {
  MediaMatAdj a;
  static_cast<MatAdj&>(a) = zero_mat_adj();
  a.medium = zero_medium_adj();
  return a;
}

__device__ __forceinline__ int light_offset(const SceneView& s, int i) { return s.lights_at + i * LIGHT_STRIDE; }
// Where material i's record starts, at the stride the adjoint's type
// compiles in: 20 for MatAdj, 26 for MediaMatAdj.
__device__ __forceinline__ int material_offset(const SceneView& s, int i, const MatAdj&) {
  return s.lights_at + s.n_lights * LIGHT_STRIDE + i * MAT_STRIDE;
}
__device__ __forceinline__ int material_offset(const SceneView& s, int i, const MediaMatAdj&) {
  return s.lights_at + s.n_lights * LIGHT_STRIDE + i * MAT_STRIDE_MEDIA;
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

// The same into a 26-scalar record, with the medium's fields.
__device__ __forceinline__ void scatter_material_adj(const GradSink& g, int off, const MediaMatAdj& a,
                                                     bool with_rgb) {
  scatter_material_adj(g, off, static_cast<const MatAdj&>(a), with_rgb);
  g.add(off + MAT_MEDIUM_DENSITY, a.medium.density);
  g.add3(off + MAT_MEDIUM_COLOR, a.medium.color);
  g.add(off + MAT_MEDIUM_ANISO, a.medium.aniso);
}

// scene.cuh sky_background with its record at sv[sky_at]: horizon(3)
// zenith(3) scale; to_linear(mix(horizon, zenith, 0.5 (rd.y + 1))) * scale.
__device__ __forceinline__ void sky_background_adj(const SceneView& s, int sky_at, V3 rd, V3 ct, const GradSink& g,
                                                   V3& c_rd) {
  const float* sky = s.sv + sky_at;
  float t = 0.5f * (rd.y + 1.0f);
  V3 hor = load3(sky), zen = load3(sky + 3);
  V3 c = mix(hor, zen, t);
  float scale = sky[6];
  g.add(sky_at + 6, dot(ct, to_linear(c)));
  V3 c_lin = ct * scale;
  V3 c_c = v3(c_lin.x * 2.2f * powf(c.x, 1.2f), c_lin.y * 2.2f * powf(c.y, 1.2f), c_lin.z * 2.2f * powf(c.z, 1.2f));
  V3 c_hor = splat3(0.0f), c_zen = splat3(0.0f);
  float c_t = 0.0f;
  mix_adj(hor, zen, t, c_c, c_hor, c_zen, c_t);
  g.add3(sky_at, c_hor);
  g.add3(sky_at + 3, c_zen);
  c_rd.y += 0.5f * c_t;
}

}  // namespace pt
