// Scalar per-thread twin of models/sdf.py: the SDF backend of the generic
// tracer (K5 inside K1 and K3), and the per-pixel march counts of K6
// (megakernel_sdf.cu).
//
// Replaces the TPU backend pathtracer_tpu/ops/megakernel_sdf.py
// (_distances, _sdf, _normal, _sphere_trace, _closest_hit_sdf,
// _any_hit_sdf, _background_sdf). The packed layout is
// ops/megakernel_sdf.pack_sdf_scene's (scene.cuh has the rest):
//
//   [0, 12)   camera
//   S x 4     sphere: center(3) radius
//   B x 7     rounded box: center(3) half(3) round
//   T x 5     torus: center(3) major minor
//   17        plane point(3) normal(3), smooth_k, checker scale, checker
//             albedo(2), sky horizon(3) zenith(3) scale
//   L x 15, M x 20   lights and materials, M = S + B + T + 1 (plane last)
//
// The primitive counts are compile-time values, as the JAX kernel's
// _sdf_meta makes them static: the backend is a template over SdfCounts<S,
// B, T>, and megakernel_sdf.cu is built once for each count triple
// (ops/_build). So the distance field, its gradient and the union fold
// unroll over the primitives, every record sits at a fixed offset, and the
// compiler can interleave the primitives' square roots. The records are
// read from the packed vector that the kernels copy to shared memory.
//
// Rounding. The march decides at every step (|d| < HIT_EPS, the overstep
// test), so the last bit of d moves where a lane stops, by about HIT_EPS in
// t. Every product that feeds a sum in the distance field, the normal and
// the march is mul_rn (never contracted into an FMA) and the ray point is
// madd3, so the arithmetic rounds as the plain version's separate tensor ops
// do and the kernel marches the plain version's steps.
//
// Not ported: the dead-lane probe rays of the TPU kernel
// (ops/megakernel.py:959-973). A TPU tile's march waits for every lane,
// dead or not, so the JAX kernel points dead lanes where they escape at
// once; here a thread whose path is dead has left its bounce loop and
// marches nothing.
#pragma once

#include "tracer.cuh"

namespace pt {

constexpr int SDF_MAX_STEPS = 96;
constexpr float SDF_T_MAX = 50.0f;
constexpr float HIT_EPS = 1e-3f;
constexpr float OMEGA = 1.6f;  // over-relaxation until a lane's first overstep
constexpr int SDF_PRIMS = 12;  // the first primitive record, after the camera
constexpr int SDF_TAIL = 17;   // plane, smooth_k, checker and sky records

// Where the light records start (host side, for the launch).
inline int sdf_lights_at(int n_spheres, int n_boxes, int n_tori) {
  return SDF_PRIMS + 4 * n_spheres + 7 * n_boxes + 5 * n_tori + SDF_TAIL;
}

// The SDF scene's view with its primitive counts (host side, as above).
inline SceneView sdf_view(const float* sv, int n_lights, int n_materials, int n_spheres, int n_boxes, int n_tori) {
  return {sv, n_lights, n_materials, false, sdf_lights_at(n_spheres, n_boxes, n_tori), n_spheres, n_boxes, n_tori};
}

// The scene's primitive counts, fixed when the backend is compiled, and the
// records' offsets in the packed vector.
template <int S, int B, int T>
struct SdfCounts {
  static constexpr int SPHERES = S, BOXES = B, TORI = T;
  static constexpr int PRIMS = S + B + T + 1;  // the plane included: the material table's records
  static constexpr int PLANE = SDF_PRIMS + 4 * S + 7 * B + 5 * T;  // the plane record
  static constexpr int END = PLANE + SDF_TAIL;  // the first light record
  // Whether a launch's counts are these.
  static bool matches(int n_spheres, int n_boxes, int n_tori) {
    return n_spheres == S && n_boxes == B && n_tori == T;
  }
};

// Calls f(C{}) for the first C of Cs whose counts are the scene's; false
// where none is (host code: a shim built for a few scenes).
template <class... Cs, class F>
bool with_sdf_counts(int n_spheres, int n_boxes, int n_tori, F&& f) {
  return ((Cs::matches(n_spheres, n_boxes, n_tori) ? (f(Cs{}), true) : false) || ...);
}

// The plane record of packed vector `sv`: point(3) normal(3), then
// smooth_k (+6), checker scale (+7), albedo (+8, +9) and the sky (+10).
template <class C>
__device__ __forceinline__ const float* sdf_plane(const float* sv) {
  return sv + C::PLANE;
}

__device__ __forceinline__ V3 abs3(V3 a) { return v3(fabsf(a.x), fabsf(a.y), fabsf(a.z)); }

// jax.grad's share of one operand of maximum/minimum: 1 where it wins, 0.5
// at a tie, 0 where it loses.
__device__ __forceinline__ float share(bool wins, bool tie) { return wins ? 1.0f : (tie ? 0.5f : 0.0f); }
__device__ __forceinline__ float safe_inv(float s) { return s > 0.0f ? 1.0f / s : 0.0f; }

// A primitive's distance and its gradient in x. gradient(x, r).d is
// distance(x, r) bit for bit: the same operations in the same order.
struct DistGrad {
  float d;
  V3 g;
};

struct Sphere {
  static constexpr int STRIDE = 4;
  __device__ __forceinline__ static float distance(V3 x, const float* r) {
    V3 q = x - load3(r);
    return sqrtf(dot_rn(q, q)) - r[3];
  }
  __device__ __forceinline__ static DistGrad gradient(V3 x, const float* r) {
    V3 q = x - load3(r);
    float length = sqrtf(dot_rn(q, q));
    return {length - r[3], q / length};
  }
};

struct RoundBox {
  static constexpr int STRIDE = 7;
  __device__ __forceinline__ static float distance(V3 x, const float* r) {
    V3 q = abs3(x - load3(r)) - load3(r + 3);
    V3 o = v3(fmaxf(q.x, 0.0f), fmaxf(q.y, 0.0f), fmaxf(q.z, 0.0f));
    float inside = fminf(fmaxf(q.x, fmaxf(q.y, q.z)), 0.0f);
    return safe_sqrt(dot_rn(o, o)) + inside - r[6];
  }
  __device__ __forceinline__ static DistGrad gradient(V3 x, const float* r) {
    V3 rel = x - load3(r);
    V3 q = abs3(rel) - load3(r + 3);
    V3 o = v3(fmaxf(q.x, 0.0f), fmaxf(q.y, 0.0f), fmaxf(q.z, 0.0f));
    float out_len = safe_sqrt(dot_rn(o, o));
    float inv_len = safe_inv(out_len);
    float m_yz = fmaxf(q.y, q.z);
    float m = fmaxf(q.x, m_yz);
    float d = out_len + fminf(m, 0.0f) - r[6];
    // Shares of the inner minimum(m, 0) and of the maxima over q.
    float w_in = share(m < 0.0f, m == 0.0f);
    float wx = share(q.x > m_yz, q.x == m_yz);
    float w_yz = share(q.y > q.z, q.y == q.z);
    auto comp = [&](float rel_c, float q_c, float o_c, float w_c) {
      float d_q = mul_rn(o_c * inv_len, share(q_c > 0.0f, q_c == 0.0f)) + mul_rn(w_in, w_c);
      return rel_c >= 0.0f ? d_q : -d_q;  // jnp.abs's slope, +1 at 0
    };
    return {d, v3(comp(rel.x, q.x, o.x, wx), comp(rel.y, q.y, o.y, (1.0f - wx) * w_yz),
                  comp(rel.z, q.z, o.z, (1.0f - wx) * (1.0f - w_yz)))};
  }
};

struct Torus {
  static constexpr int STRIDE = 5;
  __device__ __forceinline__ static float distance(V3 x, const float* r) {
    V3 q = x - load3(r);
    float ring = safe_sqrt(mul_rn(q.x, q.x) + mul_rn(q.z, q.z)) - r[3];
    return safe_sqrt(mul_rn(ring, ring) + mul_rn(q.y, q.y)) - r[4];
  }
  __device__ __forceinline__ static DistGrad gradient(V3 x, const float* r) {
    V3 q = x - load3(r);
    float s_a = safe_sqrt(mul_rn(q.x, q.x) + mul_rn(q.z, q.z));
    float ring = s_a - r[3];
    float s_b = safe_sqrt(mul_rn(ring, ring) + mul_rn(q.y, q.y));
    float inv_a = safe_inv(s_a), inv_b = safe_inv(s_b);
    float ring_b = ring * inv_b;
    return {s_b - r[4], v3(q.x * inv_a * ring_b, q.y * inv_b, q.z * inv_a * ring_b)};
  }
};

struct Plane {
  __device__ __forceinline__ static float distance(V3 x, const float* r) { return dot_rn(x - load3(r), load3(r + 3)); }
  __device__ __forceinline__ static DistGrad gradient(V3 x, const float* r) { return {distance(x, r), load3(r + 3)}; }
};

// f(Primitive{}, record) for every primitive in material-table order
// (spheres, boxes, tori, the plane), each record at its fixed offset in
// packed vector `sv`; every loop's trip count is a constant.
template <class C, class F>
__device__ __forceinline__ void for_each_primitive(const float* sv, F f) {
#pragma unroll
  for (int i = 0; i < C::SPHERES; ++i) f(Sphere{}, sv + SDF_PRIMS + Sphere::STRIDE * i);
#pragma unroll
  for (int i = 0; i < C::BOXES; ++i) f(RoundBox{}, sv + SDF_PRIMS + Sphere::STRIDE * C::SPHERES + RoundBox::STRIDE * i);
#pragma unroll
  for (int i = 0; i < C::TORI; ++i) f(Torus{}, sdf_plane<C>(sv) - Torus::STRIDE * (C::TORI - i));
  f(Plane{}, sdf_plane<C>(sv));
}

// Polynomial smooth union, as models/sdf.smooth_min: the blend h and
// smin = b (1 - h) + a h - k h (1 - h) where k > 0, the hard min otherwise.
__device__ __forceinline__ float smooth_h(float a, float b, float k) {
  return clampf(0.5f + 0.5f * (b - a) / (k > 0.0f ? k : 1.0f), 0.0f, 1.0f);
}

__device__ __forceinline__ float smooth_min(float a, float b, float k) {
  if (!(k > 0.0f)) return fminf(a, b);
  float h = smooth_h(a, b, k);
  return mul_rn(b, 1.0f - h) + mul_rn(a, h) - mul_rn(mul_rn(k, h), 1.0f - h);
}

// d smooth_min(a, b, k) / da; d/db is one minus it.
__device__ __forceinline__ float union_share(float a, float b, float k) {
  return k > 0.0f ? smooth_h(a, b, k) : share(a < b, a == b);
}

// The scene's distance: the smooth union of the primitives, in order.
template <class C>
__device__ __forceinline__ float scene_sdf(const float* sv, V3 x) {
  const float k = sdf_plane<C>(sv)[6];
  float d = 0.0f;
  bool first = true;
  for_each_primitive<C>(sv, [&](auto prim, const float* r) {
    float di = prim.distance(x, r);
    d = first ? di : smooth_min(d, di, k);
    first = false;
  });
  return d;
}

// grad_x scene_sdf, models/sdf.sdf_gradient: each primitive's gradient
// folded through the union with its shares. `nearest` is set to the
// nearest primitive at x (nearest_primitive's, the first minimum of the
// distances each gradient returns), so the closest hit needs no second
// pass over the field.
template <class C>
__device__ __forceinline__ V3 sdf_gradient(const float* sv, V3 x, int& nearest) {
  const float k = sdf_plane<C>(sv)[6];
  DistGrad u = {0.0f, splat3(0.0f)};
  float best = 0.0f;
  int i = 0;
  nearest = 0;
  for_each_primitive<C>(sv, [&](auto prim, const float* r) {
    DistGrad b = prim.gradient(x, r);
    if (i == 0) {
      u = b;
      best = b.d;
    } else {
      if (b.d < best) {
        best = b.d;
        nearest = i;
      }
      float w = union_share(u.d, b.d, k);
      u.g = v3(mul_rn(u.g.x, w) + mul_rn(b.g.x, 1.0f - w), mul_rn(u.g.y, w) + mul_rn(b.g.y, 1.0f - w),
               mul_rn(u.g.z, w) + mul_rn(b.g.z, 1.0f - w));
      u.d = smooth_min(u.d, b.d, k);
    }
    ++i;
  });
  return u.g;
}

template <class C>
__device__ __forceinline__ V3 sdf_gradient(const float* sv, V3 x) {
  int nearest;
  return sdf_gradient<C>(sv, x, nearest);
}

// normalize(grad_x scene_sdf), models/sdf.sdf_normal.
template <class C>
__device__ __forceinline__ V3 sdf_normal(const float* sv, V3 x) {
  return safe_normalize(sdf_gradient<C>(sv, x));
}

// Material id at x: the nearest primitive, the first minimum winning.
template <class C>
__device__ __forceinline__ int nearest_primitive(const float* sv, V3 x) {
  int idx = 0, i = 0;
  float best = 0.0f;
  for_each_primitive<C>(sv, [&](auto prim, const float* r) {
    float d = prim.distance(x, r);
    if (i == 0 || d < best) {
      best = d;
      idx = i;
    }
    ++i;
  });
  return idx;
}

struct MarchResult {
  float t;    // where the lane stopped
  int steps;  // the step (1-based) at which it stopped; SDF_MAX_STEPS if never
  float d;    // scene_sdf at t
};

// The over-relaxed march of models/sdf.march from ro along rd: step
// OMEGA * d until the first overstep (|d| + |d_prev| < the last step),
// which backtracks by (OMEGA - 1) times the last step and marches plainly
// after. A lane stops when |d| < HIT_EPS on a step that did not fail, when
// t > SDF_T_MAX, or when t > cap on a step that did not fail (no backtrack
// pending, so no occluder before t is left unseen). cap >= SDF_T_MAX is the
// uncapped march. The distance at the returned t is the last step's where
// the march stops inside its loop, and is evaluated once more only after
// the last step.
template <class C>
__device__ __forceinline__ MarchResult sdf_march(const float* sv, V3 ro, V3 rd, float cap) {
  float t = 0.0f, prev_r = 0.0f, step_len = 0.0f, omega = OMEGA;
#pragma unroll 1
  for (int k = 1; k <= SDF_MAX_STEPS; ++k) {
    float d = scene_sdf<C>(sv, madd3(ro, rd, t));
    float r = fabsf(d);
    bool fail = omega > 1.0f && r + prev_r < step_len;
    if ((!fail && r < HIT_EPS) || t > SDF_T_MAX || (t > cap && !fail)) return {t, k, d};
    float new_step = fail ? -mul_rn(omega - 1.0f, step_len) : mul_rn(d, omega);
    t = t + new_step;
    prev_r = r;
    step_len = new_step;
    if (fail) omega = 1.0f;
  }
  return {t, SDF_MAX_STEPS, scene_sdf<C>(sv, madd3(ro, rd, t))};
}

// The hit test at the marched t: |sdf(ro + rd t)| < 2 HIT_EPS and t <=
// SDF_T_MAX, from the distance the march returns with t.
__device__ __forceinline__ bool sdf_converged(const MarchResult& m) {
  return fabsf(m.d) < 2.0f * HIT_EPS && m.t <= SDF_T_MAX;
}

// Which checker albedo the hit point x takes (0 or 1): fmod(|x1 + z1|, 2)
// < 1 picks the first (not the analytical checker, which reads the ray
// direction).
template <class C>
__device__ __forceinline__ int sdf_checker_pick(const float* sv, V3 x) {
  const float* pl = sdf_plane<C>(sv);
  float x1 = fmodf(floorf(x.x * pl[7]), 2.0f);
  float z1 = fmodf(floorf(x.z * pl[7]), 2.0f);
  return fmodf(fabsf(x1 + z1), 2.0f) < 1.0f ? 0 : 1;
}

template <class C>
__device__ __forceinline__ float sdf_checker(const float* sv, V3 x) {
  return sdf_plane<C>(sv)[8 + sdf_checker_pick<C>(sv, x)];
}

// Sphere-traced closest hit: t (+inf on a miss), the normal (at ro on a
// miss: never used, but finite) and the un-finalized material (the default
// one on a miss; the checker's albedo on the plane).
template <class C, class M = Material>
__device__ __forceinline__ float sdf_closest_hit(const SceneView& s, V3 ro, V3 rd, V3& normal, M& mat) {
  const MarchResult m = sdf_march<C>(s.sv, ro, rd, SDF_T_MAX);
  const bool hit = sdf_converged(m);
  const V3 x = madd3(ro, rd, hit ? m.t : 0.0f);
  int idx;
  normal = safe_normalize(sdf_gradient<C>(s.sv, x, idx));
  if (!hit) {
    mat = default_material();
    return INFINITY;
  }
  load_material(s, idx, mat);
  if (idx == C::PRIMS - 1) mat.rgb = splat3(sdf_checker<C>(s.sv, x));
  return m.t;
}

// Shadow occlusion closer than max_dist. The march is capped at max_dist:
// a lane past the cap with no backtrack pending has no surface before it,
// and t never falls back below it, so the uncapped march of the plain
// version (models/sdf.any_hit) decides the same.
template <class C>
__device__ __forceinline__ bool sdf_any_hit(const SceneView& s, V3 ro, V3 rd, float max_dist) {
  const MarchResult m = sdf_march<C>(s.sv, ro, rd, fminf(max_dist, SDF_T_MAX));
  return sdf_converged(m) && m.t < max_dist;
}

// The SDF backend of the generic tracer for the counts C.
template <class C>
struct Sdf {
  using Counts = C;
  template <class M = Material>
  __device__ __forceinline__ static float closest_hit(const SceneView& s, V3 ro, V3 rd, V3& normal, M& mat) {
    return sdf_closest_hit<C>(s, ro, rd, normal, mat);
  }
  __device__ __forceinline__ static bool any_hit(const SceneView& s, V3 ro, V3 rd, float max_dist) {
    return sdf_any_hit<C>(s, ro, rd, max_dist);
  }
  __device__ __forceinline__ static V3 background(const SceneView& s, V3 rd) {
    return sky_background(sdf_plane<C>(s.sv) + 10, rd);
  }
};

// K6 at pixel p (ops/megakernel_sdf.march_steps_reference): the trips of
// the primary march of the pixel's center ray, and of the NEE shadow march
// from its hit point as the JAX package's measure_march_steps rebuilds it
// (the face-forward normal times EPS off the surface, the center-of-light
// sample, capped at the light's distance; a cap of 0 on a miss or a lane
// that does not face the light).
template <class C>
__device__ __forceinline__ void march_steps_pixel(const SceneView& s, int p, int width, int height, int& steps,
                                                  int& shadow_steps) {
  V3 q;
  float sx, sy;
  const V3 ro = load3(s.sv + SV_CAM_ORIGIN);
  const V3 rd = camera_ray(s, p, width, height, 0.5f, 0.5f, q, sx, sy);
  const MarchResult m = sdf_march<C>(s.sv, ro, rd, SDF_T_MAX);
  const bool hit = sdf_converged(m);
  const V3 x = madd3(ro, rd, hit ? m.t : 0.0f);
  const V3 n = sdf_normal<C>(s.sv, x);
  const V3 scatter = madd3(x, dot_rn(n, rd) > 0.0f ? -n : n, EPS);
  const int idx = min(max((int)(0.5f * (float)s.n_lights), 0), s.n_lights - 1);
  const LightSample ls = sample_light(s, idx, scatter, 0.5f, 0.5f);
  const float cap = dot_rn(ls.direction, ls.normal) < 0.0f && hit ? ls.dist - EPS : 0.0f;
  steps = m.steps;
  shadow_steps = sdf_march<C>(s.sv, scatter, ls.direction, fminf(cap, SDF_T_MAX)).steps;
}

}  // namespace pt
