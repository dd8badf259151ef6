// The scene-backend plugins of tests/torch_plugin_toy.py in CUDA C++: what
// a package outside pathtracer_tpu_torch writes to run its scene family on
// the card (ops/megakernel.KernelBackend's `header`). ops/_build.py
// compiles csrc/megakernel_plugin.cu with this header included and one of
// these structs named as the backend:
//
//   toy::Toy, toy::ToyAdj  the one-sphere toy of tests/test_backend_plugin.py
//                          (K1, K3 and K2): its vector holds the camera (12),
//                          the center (3) and radius at 12, the sky's horizon
//                          (3), zenith (3) and scale at 16, then the light and
//                          material records (one material)
//   toy::ToyExtra          the same sphere with its center and radius in an
//                          extra tensor (extras[0]: x y z radius) and the sky
//                          at 12 (forward-only)
//   toy::Stripes           the analytical scene with the JAX package's
//                          `_stripes` procedural hook (tests/test_procedural.py)
//                          applied after its closest hit (forward-only)
//
// A forward struct has tracer.cuh's hooks, an adjoint struct (derived from
// it) tracer_adj.cuh's as well; both read the packed vector through
// SceneView (scene.cuh; the light and material records as scene.cuh's
// helpers find them). Each mirrors its eager twin in torch_plugin_toy.py
// operation for operation: the sphere test in double and ray points
// unfused (madd3), as the built-in backends keep them.
#pragma once

#include "analytical_adj.cuh"
#include "intersect_adj.cuh"
#include "scene_adj.cuh"

namespace toy {

using namespace pt;

enum : int { TOY_CENTER = 12, TOY_RADIUS = 15, TOY_SKY = 16, EXTRA_SKY = 12 };

// The sphere's closest hit at `center`, `radius`: t (+inf on a miss, where
// the material is Material::new), the outward normal and material 0.
template <class M>
__device__ __forceinline__ float sphere_hit(const SceneView& s, V3 center, float radius, V3 ro, V3 rd, V3& normal,
                                            M& mat) {
  const float t = ray_sphere(ro, rd, center, radius);
  const bool hit = isfinite(t);
  normal = safe_normalize(madd3(ro, rd, hit ? t : 0.0f) - center);
  if (!hit) {
    mat = default_material();
    return INFINITY;
  }
  load_material(s, 0, mat);
  return t;
}

struct Toy {
  template <class M = Material>
  __device__ __forceinline__ static float closest_hit(const SceneView& s, V3 ro, V3 rd, V3& normal, M& mat) {
    return sphere_hit(s, load3(s.sv + TOY_CENTER), s.sv[TOY_RADIUS], ro, rd, normal, mat);
  }
  __device__ __forceinline__ static bool any_hit(const SceneView& s, V3 ro, V3 rd, float max_dist) {
    const float t = ray_sphere(ro, rd, load3(s.sv + TOY_CENTER), s.sv[TOY_RADIUS]);
    return isfinite(t) && t < max_dist;
  }
  __device__ __forceinline__ static V3 background(const SceneView& s, V3 rd) {
    return sky_background(s.sv + TOY_SKY, rd);
  }
};

// The toy's adjoint hooks (K2): the winner is the sphere (1), its
// cotangents go to the center, the radius, material 0's record and the sky.
struct ToyAdj : Toy {
  __device__ __forceinline__ static float closest_hit_rec(const SceneView& s, V3 ro, V3 rd, int& win) {
    win = 1;
    const float t = ray_sphere(ro, rd, load3(s.sv + TOY_CENTER), s.sv[TOY_RADIUS]);
    return isfinite(t) ? t : INFINITY;
  }
  template <class M>
  __device__ __forceinline__ static void surface(const SceneView& s, V3 ro, V3 rd, float t, int, V3& normal, M& mat) {
    normal = safe_normalize(madd3(ro, rd, t) - load3(s.sv + TOY_CENTER));
    load_material(s, 0, mat);
  }
  // On a ray that hit at t: the normal's cotangent through safe_normalize
  // and the hit point, t's through the sphere test, the raw material's into
  // record 0 (A: MatAdj, or MediaMatAdj at stride 26).
  template <class A>
  __device__ __forceinline__ static void closest_hit_adj(const SceneView& s, V3 ro, V3 rd, float t, int, float ct_t,
                                                         V3 ct_normal, const A& a, const GradSink& g, V3& c_ro,
                                                         V3& c_rd) {
    const V3 center = load3(s.sv + TOY_CENTER);
    const V3 c_q = safe_normalize_adj(madd3(ro, rd, t) - center, ct_normal);
    g.add3(TOY_CENTER, -c_q);
    c_ro += c_q;
    c_rd += c_q * t;
    ct_t += dot(c_q, rd);
    V3 c_center = splat3(0.0f);
    float c_radius = 0.0f;
    ray_sphere_adj(ro, rd, center, s.sv[TOY_RADIUS], ct_t, c_ro, c_rd, c_center, c_radius);
    g.add3(TOY_CENTER, c_center);
    g.add(TOY_RADIUS, c_radius);
    scatter_material_adj(g, material_offset(s, 0, a), a, true);
  }
  __device__ __forceinline__ static void background_adj(const SceneView& s, V3 rd, V3 ct, const GradSink& g,
                                                        V3& c_rd) {
    sky_background_adj(s, TOY_SKY, rd, ct, g, c_rd);
  }
};

// The toy with its sphere in the plugin's extra tensor: extras[0] holds
// the center (3) and the radius.
struct ToyExtra {
  template <class M = Material>
  __device__ __forceinline__ static float closest_hit(const SceneView& s, V3 ro, V3 rd, V3& normal, M& mat) {
    const float* sphere = s.extras[0];
    return sphere_hit(s, load3(sphere), sphere[3], ro, rd, normal, mat);
  }
  __device__ __forceinline__ static bool any_hit(const SceneView& s, V3 ro, V3 rd, float max_dist) {
    const float* sphere = s.extras[0];
    const float t = ray_sphere(ro, rd, load3(sphere), sphere[3]);
    return isfinite(t) && t < max_dist;
  }
  __device__ __forceinline__ static V3 background(const SceneView& s, V3 rd) {
    return sky_background(s.sv + EXTRA_SKY, rd);
  }
};

// The analytical scene with the JAX package's `_stripes` hook
// (tests/test_procedural.py:16-27) after its closest hit: the albedo
// becomes 0.05 where floor(4 x) of the hit point's x is odd. Python's `%`
// on a float floors, so the remainder takes the divisor's sign: fmodf
// truncates and differs for negative x, hence the correction (the
// analytical checker keeps fmodf on purpose: the reference's Rust `%`
// truncates). The hit point's x rounds its product and sum apart, as the
// eager twin's separate operations do.
struct Stripes : Analytical {
  template <class M = Material>
  __device__ __forceinline__ static float closest_hit(const SceneView& s, V3 ro, V3 rd, V3& normal, M& mat) {
    const float t = Analytical::closest_hit(s, ro, rd, normal, mat);
    const float x = __fadd_rn(ro.x, __fmul_rn(rd.x, isfinite(t) ? t : 0.0f));
    float band = fmodf(floorf(x * 4.0f), 2.0f);
    if (band < 0.0f) band += 2.0f;
    if (!(band < 1.0f)) mat.rgb = splat3(0.05f);
    return t;
  }
};

}  // namespace toy
