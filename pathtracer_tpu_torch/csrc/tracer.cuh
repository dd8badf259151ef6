// Scalar per-thread twin of integrator/tracer.py (mis estimator, no media):
// emitter pass, light sampling, NEE and the bounce loop of one sample.
#pragma once

#include "analytical.cuh"
#include "threefry.cuh"

namespace pt {

constexpr float EPS = 0.005f;
constexpr int U_PER_BOUNCE = 8;

enum : int {
  FLAG_STALE_EMITTER_GATE = 1,
  FLAG_PRIMARY_MIS = 2,
  FLAG_RESPECT_MAX_DIST = 4,
};

struct EmitterHit {
  bool hit;
  float dist, pdf;
  V3 emission;
};

// Ray vs every light in order with strict d < dist (integrator
// sample_lights_emitter): spherical pdf d^2/(0.5 area cos), rectangular
// d^2/(area cos), distant lights never hit.
__device__ __forceinline__ EmitterHit sample_lights_emitter(const SceneView& s, V3 ro, V3 rd, float gate_dist) {
  EmitterHit e = {false, gate_dist, 0.0f, splat3(0.0f)};
  for (int i = 0; i < s.n_lights; ++i) {
    const float* lt = s.light(i);
    bool is_sph = lt[14] == 1.0f;
    bool is_rect = lt[14] == 0.0f;
    V3 pos = load3(lt);
    float d = is_sph ? ray_sphere(ro, rd, pos, lt[12])
                     : (is_rect ? ray_rect(ro, rd, pos, load3(lt + 6), load3(lt + 9)) : INFINITY);
    if (!(isfinite(d) && d < e.dist && (is_sph || is_rect))) continue;
    V3 normal = is_sph ? safe_normalize((ro + rd * d) - pos) : safe_normalize(cross(load3(lt + 6), load3(lt + 9)));
    float cos_theta = dot(-rd, normal);
    float denom = lt[13] * cos_theta * (is_sph ? 0.5f : 1.0f);
    e.pdf = (d * d) / (denom != 0.0f ? denom : 1.0f);
    e.dist = d;
    e.emission = load3(lt + 3);
    e.hit = true;
  }
  return e;
}

struct LightSample {
  V3 normal, emission, direction;
  float dist, pdf;
};

// Type-dispatched sampling of light `idx` (integrator sample_light).
__device__ __forceinline__ LightSample sample_light(const SceneView& s, int idx, V3 scatter_pos, float r1, float r2) {
  const float* lt = s.light(idx);
  V3 pos = load3(lt);
  LightSample ls;
  ls.emission = load3(lt + 3) * (float)s.n_lights;
  if (lt[14] == 1.0f) {  // spherical: uniform hemisphere about the center-to-point axis
    V3 center_to_surf = scatter_pos - pos;
    float dist_to_center = length(center_to_surf);
    V3 axis = center_to_surf / splat3(dist_to_center > 0.0f ? dist_to_center : 1.0f);
    V3 t, b;
    onb(axis, t, b);
    V3 sampled_dir = to_world(t, b, axis, uniform_sample_hemisphere(r1, r2));
    V3 light_surface = pos + sampled_dir * splat3(lt[12]);
    V3 direction = light_surface - scatter_pos;
    float dist = length(direction);
    float dist_sq = dist * dist;
    ls.direction = direction / splat3(dist > 0.0f ? dist : 1.0f);
    ls.normal = safe_normalize(light_surface - pos);
    ls.dist = dist;
    float denom = lt[13] * 0.5f * fabsf(dot(ls.normal, ls.direction));
    ls.pdf = dist_sq / (denom != 0.0f ? denom : 1.0f);
  } else if (lt[14] == 0.0f) {  // rectangular: uniform point on the quad
    V3 u = load3(lt + 6), v = load3(lt + 9);
    V3 light_surface = pos + u * splat3(r1) + v * splat3(r2);
    V3 direction = light_surface - scatter_pos;
    float dist = length(direction);
    float dist_sq = dist * dist;
    ls.direction = direction / splat3(dist > 0.0f ? dist : 1.0f);
    ls.normal = safe_normalize(cross(u, v));
    ls.dist = dist;
    float denom = lt[13] * fabsf(dot(ls.normal, ls.direction));
    ls.pdf = dist_sq / (denom != 0.0f ? denom : 1.0f);
  } else {  // distant: fixed direction stored in position
    ls.direction = safe_normalize(pos);
    ls.normal = safe_normalize(scatter_pos - pos);
    ls.dist = INFINITY;
    ls.pdf = 1.0f;
  }
  return ls;
}

// Next-event estimation (integrator direct_light).
__device__ __forceinline__ V3 direct_light(const SceneView& s, V3 rd, V3 fhp, V3 ffnormal, const Material& m,
                                           float eta, float u_pick, float r1, float r2) {
  if (s.n_lights == 0) return splat3(0.0f);
  V3 scatter_pos = fhp + ffnormal * EPS;
  // Truncation toward zero, as the reference's int cast.
  int idx = min(max((int)(u_pick * (float)s.n_lights), 0), s.n_lights - 1);
  LightSample ls = sample_light(s, idx, scatter_pos, r1, r2);

  // A failed test zeroes the contribution, so later tests are skipped.
  if (!(dot(ls.direction, ls.normal) < 0.0f)) return splat3(0.0f);
  if (any_hit(s, scatter_pos, ls.direction, ls.dist - EPS)) return splat3(0.0f);
  float bsdf_pdf;
  V3 f = disney_eval(m, eta, -rd, ffnormal, ls.direction, bsdf_pdf);
  if (!(bsdf_pdf > 0.0f && ls.pdf > 0.0f)) return splat3(0.0f);
  float area = s.light(idx)[13];
  float mis_w = area > 0.0f ? power_heuristic(ls.pdf, bsdf_pdf) : 1.0f;
  return ls.emission * f * (mis_w / ls.pdf);
}

// One sample of one pixel: camera ray plus the bounce loop
// (integrator make_bounce_step), returning radiance.
__device__ __forceinline__ V3 trace_sample(const SceneView& s, int p, int n, int width, int height, float inv_w,
                                           float inv_h, int depth, int flags, uint32_t kc0, uint32_t kc1,
                                           uint32_t kb0, uint32_t kb1) {
  const bool stale_gate = flags & FLAG_STALE_EMITTER_GATE;
  const bool primary_mis = flags & FLAG_PRIMARY_MIS;

  // Camera ray (Pinhole::gen_ray with pixel_coords' (x/W, (H-1-y)/H)).
  int px = p % width, py = p / width;
  float cx = (float)px / (float)width;
  float cy = ((float)(height - 1) - (float)py) / (float)height;
  float ox = uniform_at(kc0, kc1, (uint64_t)p * 2u);
  float oy = uniform_at(kc0, kc1, (uint64_t)p * 2u + 1u);
  V3 origin = load3(s.sv + SV_CAM_ORIGIN);
  V3 rd = (load3(s.sv + SV_LOWER_LEFT) - origin) + load3(s.sv + SV_HORIZONTAL) * (inv_w * ox + cx) +
          load3(s.sv + SV_VERTICAL) * (inv_h * oy + cy);
  rd = normalize(rd);
  V3 ro = origin;

  V3 radiance = splat3(0.0f);
  V3 throughput = splat3(1.0f);
  float prev_pdf = primary_mis ? 0.0f : -1.0f;
  V3 prev_l = splat3(0.0f);
  float prev_hit_dist = -1.0f;

  for (int d = 0; d < depth; ++d) {
    uint64_t base = ((uint64_t)d * (uint64_t)n + (uint64_t)p) * U_PER_BOUNCE;

    V3 geo_normal;
    Material mat;
    float t = closest_hit(s, ro, rd, geo_normal, mat);
    bool geo_hit = isfinite(t);
    float gate_dist = geo_hit ? t : (stale_gate ? prev_hit_dist : INFINITY);
    EmitterHit em = sample_lights_emitter(s, ro, rd, gate_dist);
    bool hit = geo_hit || em.hit;
    if (!hit) {  // background, and the path dies
      radiance = radiance + background(s, rd) * throughput;
      break;
    }
    float hit_dist = em.hit ? em.dist : gate_dist;

    finalize_material(mat);
    V3 fhp = ro + rd * hit_dist;
    bool entering = dot(geo_normal, rd) <= 0.0f;
    V3 ffnormal = entering ? geo_normal : -geo_normal;
    float eta = dot(rd, geo_normal) < 0.0f ? 1.0f / mat.ior : mat.ior;

    // Alpha pass-through: Blend by the alpha coin, Mask by the cutoff.
    bool alpha_fail = (mat.alpha_mode == 1 && uniform_at(kb0, kb1, base + 6) > mat.opacity) ||
                      (mat.alpha_mode == 2 && mat.opacity < mat.alpha_cutoff);
    bool passthru = !em.hit && alpha_fail;

    if (!passthru) radiance = radiance + mat.emission * throughput;

    if (em.hit) {  // emitter hit, MIS-weighted with the previous scatter pdf
      float mis_w = power_heuristic(fmaxf(prev_pdf, 0.0f), em.pdf);
      if (!primary_mis && prev_pdf < 0.0f) mis_w = 1.0f;
      radiance = radiance + em.emission * (mis_w * 1.0f) * throughput;
    }
    prev_hit_dist = hit_dist;

    if (passthru) {  // continue straight through the surface
      ro = fhp + rd * EPS;
      continue;
    }
    if (em.hit) break;  // the path ends on a light

    V3 ld = direct_light(s, rd, fhp, ffnormal, mat, eta, uniform_at(kb0, kb1, base + 0),
                         uniform_at(kb0, kb1, base + 1), uniform_at(kb0, kb1, base + 2));
    radiance = radiance + ld * throughput;

    BsdfSample bs = disney_sample(mat, eta, -rd, ffnormal, prev_l, uniform_at(kb0, kb1, base + 3),
                                  uniform_at(kb0, kb1, base + 4), uniform_at(kb0, kb1, base + 5));
    prev_pdf = bs.pdf;
    prev_l = bs.l;
    if (!(bs.pdf > 0.0f)) break;
    throughput = throughput * bs.f / splat3(bs.pdf);
    ro = fhp + bs.l * EPS;
    rd = bs.l;
  }
  return radiance;
}

}  // namespace pt
