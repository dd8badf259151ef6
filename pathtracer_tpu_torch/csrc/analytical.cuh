// Scalar per-thread twin of models/analytical.py, reading the scene from
// the packed vector of ops/megakernel.pack_scene (media-free layout):
//
//   [0, 37)   camera lower_left(3) horizontal(3) vertical(3) origin(3),
//             sphere centers(2x3) radii(2), plane point(3) normal(3),
//             checker scale offset albedo(2), sky horizon(3) zenith(3) scale
//   L x 15    light: position(3) emission(3) u(3) v(3) radius area type
//   M x 20    material: rgb(3) anisotropic emission(3) metallic roughness
//             subsurface specular_tint sheen sheen_tint clearcoat
//             clearcoat_gloss spec_trans ior opacity alpha_mode alpha_cutoff
#pragma once

#include "bsdf.cuh"
#include "intersect.cuh"

namespace pt {

enum : int {
  SV_LOWER_LEFT = 0,
  SV_HORIZONTAL = 3,
  SV_VERTICAL = 6,
  SV_CAM_ORIGIN = 9,
  SV_SPHERE_CENTER = 12,
  SV_SPHERE_RADIUS = 18,
  SV_PLANE_POINT = 20,
  SV_PLANE_NORMAL = 23,
  SV_CHECKER_SCALE = 26,
  SV_CHECKER_OFFSET = 27,
  SV_CHECKER_ALBEDO = 28,
  SV_SKY_HORIZON = 30,
  SV_SKY_ZENITH = 33,
  SV_SKY_SCALE = 36,
  SV_LIGHTS = 37,
  LIGHT_STRIDE = 15,
  MAT_STRIDE = 20,
};

__device__ __forceinline__ V3 load3(const float* p) { return v3(p[0], p[1], p[2]); }

// The packed scene as a thread reads it, with its static structure.
struct SceneView {
  const float* sv;
  int n_lights;
  int n_materials;
  bool respect_max_dist;

  __device__ __forceinline__ const float* light(int i) const { return sv + SV_LIGHTS + i * LIGHT_STRIDE; }
  __device__ __forceinline__ const float* material(int i) const {
    return sv + SV_LIGHTS + n_lights * LIGHT_STRIDE + i * MAT_STRIDE;
  }
};

__device__ __forceinline__ Material load_material(const float* p) {
  Material m = default_material();
  m.rgb = load3(p + 0);
  m.anisotropic = p[3];
  m.emission = load3(p + 4);
  m.metallic = p[7];
  m.roughness = p[8];
  m.subsurface = p[9];
  m.specular_tint = p[10];
  m.sheen = p[11];
  m.sheen_tint = p[12];
  m.clearcoat = p[13];
  m.clearcoat_gloss = p[14];
  m.spec_trans = p[15];
  m.ior = p[16];
  m.opacity = p[17];
  m.alpha_mode = (int)p[18];
  m.alpha_cutoff = p[19];
  return m;
}

// Sky gradient: gamma-2.2-decoded lerp scaled by sky_scale.
__device__ __forceinline__ V3 background(const SceneView& s, V3 rd) {
  float t = 0.5f * (rd.y + 1.0f);
  V3 c = mix(load3(s.sv + SV_SKY_HORIZON), load3(s.sv + SV_SKY_ZENITH), t);
  return to_linear(c) * splat3(s.sv[SV_SKY_SCALE]);
}

__device__ __forceinline__ void primitive_ts(const SceneView& s, V3 ro, V3 rd, float& t0, float& t1, float& tp) {
  t0 = ray_sphere(ro, rd, load3(s.sv + SV_SPHERE_CENTER), s.sv[SV_SPHERE_RADIUS]);
  t1 = ray_sphere(ro, rd, load3(s.sv + SV_SPHERE_CENTER + 3), s.sv[SV_SPHERE_RADIUS + 1]);
  tp = ray_plane(ro, rd, load3(s.sv + SV_PLANE_NORMAL), load3(s.sv + SV_PLANE_POINT));
}

// Closest of [sphere0, sphere1, plane], first min wins. Returns t (+inf on
// a miss, where the material is Material::new), the normal and the
// un-finalized material; the plane's albedo is the checker computed from
// the ray direction with Rust's truncated float `%` (fmodf).
__device__ __forceinline__ float closest_hit(const SceneView& s, V3 ro, V3 rd, V3& normal, Material& mat) {
  float t0, t1, tp;
  primitive_ts(s, ro, rd, t0, t1, tp);
  float t = fminf(fminf(t0, t1), tp);
  int idx = t == t0 ? 0 : (t == t1 ? 1 : 2);
  bool hit = isfinite(t);

  V3 hp = ro + rd * (hit ? t : 0.0f);
  V3 center = load3(s.sv + SV_SPHERE_CENTER + (idx == 0 ? 0 : 3));
  normal = idx == 2 ? load3(s.sv + SV_PLANE_NORMAL) : safe_normalize(hp - center);

  if (!hit) {
    mat = default_material();
    return INFINITY;
  }
  mat = load_material(s.material(min(idx, s.n_materials - 1)));
  if (idx == 2) {
    float safe_dy = rd.y != 0.0f ? rd.y : 1.0f;
    float cx = rd.x / safe_dy * s.sv[SV_CHECKER_SCALE] + s.sv[SV_CHECKER_OFFSET];
    float cy = rd.z / safe_dy * s.sv[SV_CHECKER_SCALE] + s.sv[SV_CHECKER_OFFSET];
    float x1 = fmodf(floorf(cx), 2.0f);
    float y1 = fmodf(floorf(cy), 2.0f);
    mat.rgb = splat3(fmodf(x1 + y1, 2.0f) < 1.0f ? s.sv[SV_CHECKER_ALBEDO] : s.sv[SV_CHECKER_ALBEDO + 1]);
  }
  return t;
}

// Shadow-ray occlusion. The reference's any_hit ignores max_dist (any hit at
// any distance occludes); any_hit_respecting_max_dist does not.
__device__ __forceinline__ bool any_hit(const SceneView& s, V3 ro, V3 rd, float max_dist) {
  float t0, t1, tp;
  primitive_ts(s, ro, rd, t0, t1, tp);
  if (s.respect_max_dist) return fminf(fminf(t0, t1), tp) < max_dist;
  return isfinite(t0) || isfinite(t1) || isfinite(tp);
}

}  // namespace pt
