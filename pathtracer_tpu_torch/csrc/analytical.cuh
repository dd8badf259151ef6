// Scalar per-thread twin of models/analytical.py, the analytical backend of
// the generic tracer (tracer.cuh), reading the scene from the packed vector
// of ops/megakernel.pack_scene (media-free layout; scene.cuh has the camera,
// light and material records):
//
//   [0, 37)   camera(12), sphere centers(2x3) radii(2), plane point(3)
//             normal(3), checker scale offset albedo(2), sky horizon(3)
//             zenith(3) scale
//   L x 15    lights, then M x 20 materials
#pragma once

#include "intersect.cuh"
#include "scene.cuh"

namespace pt {

enum : int {
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
};

// The analytical scene's view (host side, for the launch and the host build).
inline SceneView analytical_view(const float* sv, int n_lights, int n_materials, bool respect_max_dist) {
  return {sv, n_lights, n_materials, respect_max_dist, SV_LIGHTS, 0, 0, 0};
}

// Sky gradient: gamma-2.2-decoded lerp scaled by sky_scale.
__device__ __forceinline__ V3 background(const SceneView& s, V3 rd) { return sky_background(s.sv + SV_SKY_HORIZON, rd); }

__device__ __forceinline__ void primitive_ts(const SceneView& s, V3 ro, V3 rd, float& t0, float& t1, float& tp) {
  t0 = ray_sphere(ro, rd, load3(s.sv + SV_SPHERE_CENTER), s.sv[SV_SPHERE_RADIUS]);
  t1 = ray_sphere(ro, rd, load3(s.sv + SV_SPHERE_CENTER + 3), s.sv[SV_SPHERE_RADIUS + 1]);
  tp = ray_plane(ro, rd, load3(s.sv + SV_PLANE_NORMAL), load3(s.sv + SV_PLANE_POINT));
}

// Closest of [sphere0, sphere1, plane], first min wins. Returns t (+inf on
// a miss, where the material is Material::new), the normal and the
// un-finalized material; the plane's albedo is the checker computed from
// the ray direction with Rust's truncated float `%` (fmodf).
template <class M = Material>
__device__ __forceinline__ float closest_hit(const SceneView& s, V3 ro, V3 rd, V3& normal, M& mat) {
  float t0, t1, tp;
  primitive_ts(s, ro, rd, t0, t1, tp);
  float t = fminf(fminf(t0, t1), tp);
  int idx = t == t0 ? 0 : (t == t1 ? 1 : 2);
  bool hit = isfinite(t);

  V3 hp = madd3(ro, rd, hit ? t : 0.0f);
  V3 center = load3(s.sv + SV_SPHERE_CENTER + (idx == 0 ? 0 : 3));
  normal = idx == 2 ? load3(s.sv + SV_PLANE_NORMAL) : safe_normalize(hp - center);

  if (!hit) {
    mat = default_material();
    return INFINITY;
  }
  load_material(s, min(idx, s.n_materials - 1), mat);
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

// The analytical backend of the generic tracer.
struct Analytical {
  template <class M = Material>
  __device__ __forceinline__ static float closest_hit(const SceneView& s, V3 ro, V3 rd, V3& normal, M& mat) {
    return pt::closest_hit(s, ro, rd, normal, mat);
  }
  __device__ __forceinline__ static bool any_hit(const SceneView& s, V3 ro, V3 rd, float max_dist) {
    return pt::any_hit(s, ro, rd, max_dist);
  }
  __device__ __forceinline__ static V3 background(const SceneView& s, V3 rd) { return pt::background(s, rd); }
};

}  // namespace pt
