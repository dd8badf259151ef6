// Scalar per-thread twin of integrator/tracer.py (mis estimator): emitter
// pass, light sampling, NEE and the bounce loop of one sample. The media
// segment (Absorb, Emissive, HG single Scatter) is media_bounce, which only
// the kernels' MEDIA instantiation runs (a scene whose material table
// declares a medium, as the JAX kernel's has_media); the media-free bounce
// compiles none of it.
//
// Generic over the scene backend B, the counterpart of the JAX package's
// KernelBackend (ops/megakernel.py): a type with static
//   float B::closest_hit(s, ro, rd, normal&, material&)  (+inf on a miss)
//   bool  B::any_hit(s, ro, rd, max_dist)
//   V3    B::background(s, rd)
// over the packed scene of scene.cuh (Analytical in analytical.cuh, Sdf in
// sdf.cuh).
#pragma once

#include "intersect.cuh"
#include "scene.cuh"
#include "threefry.cuh"

namespace pt {

constexpr float EPS = 0.005f;

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
    V3 normal = is_sph ? safe_normalize(madd3(ro, rd, d) - pos) : safe_normalize(cross(load3(lt + 6), load3(lt + 9)));
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
template <class B>
__device__ __forceinline__ V3 direct_light(const SceneView& s, V3 rd, V3 fhp, V3 ffnormal, const Material& m,
                                           float eta, float u_pick, float r1, float r2) {
  if (s.n_lights == 0) return splat3(0.0f);
  V3 scatter_pos = madd3(fhp, ffnormal, EPS);
  // Truncation toward zero, as the reference's int cast.
  int idx = min(max((int)(u_pick * (float)s.n_lights), 0), s.n_lights - 1);
  LightSample ls = sample_light(s, idx, scatter_pos, r1, r2);

  // A failed test zeroes the contribution, so later tests are skipped.
  if (!(dot(ls.direction, ls.normal) < 0.0f)) return splat3(0.0f);
  if (B::any_hit(s, scatter_pos, ls.direction, ls.dist - EPS)) return splat3(0.0f);
  float bsdf_pdf;
  V3 f = disney_eval(m, eta, -rd, ffnormal, ls.direction, bsdf_pdf);
  if (!(bsdf_pdf > 0.0f && ls.pdf > 0.0f)) return splat3(0.0f);
  float area = s.light(idx)[13];
  float mis_w = area > 0.0f ? power_heuristic(ls.pdf, bsdf_pdf) : 1.0f;
  return ls.emission * f * (mis_w / ls.pdf);
}

// Next-event estimation of the media instantiation, at a surface
// (direct_light's, from scatter_pos = fhp + ffnormal * EPS) or, with
// `phase`, at a volumetric scatter point (integrator
// scatter_direct_light): there the HG phase of anisotropy g is the value
// and the pdf in place of the Disney BSDF. One function for both, so the
// shadow ray (the SDF's march) is inlined once.
template <class B>
__device__ __forceinline__ V3 media_direct_light(const SceneView& s, V3 rd, V3 scatter_pos, V3 ffnormal,
                                                 const Material& m, float eta, bool phase, float g, float u_pick,
                                                 float r1, float r2) {
  if (s.n_lights == 0) return splat3(0.0f);
  int idx = min(max((int)(u_pick * (float)s.n_lights), 0), s.n_lights - 1);
  LightSample ls = sample_light(s, idx, scatter_pos, r1, r2);
  if (!(dot(ls.direction, ls.normal) < 0.0f)) return splat3(0.0f);
  if (B::any_hit(s, scatter_pos, ls.direction, ls.dist - EPS)) return splat3(0.0f);
  float area = s.light(idx)[13];
  if (phase) {
    float p = hg_phase(dot(rd, ls.direction), g);
    if (!(p > 0.0f && ls.pdf > 0.0f)) return splat3(0.0f);
    float mis_w = area > 0.0f ? power_heuristic(ls.pdf, p) : 1.0f;
    return ls.emission * splat3(mis_w * p / ls.pdf);
  }
  float bsdf_pdf;
  V3 f = disney_eval(m, eta, -rd, ffnormal, ls.direction, bsdf_pdf);
  if (!(bsdf_pdf > 0.0f && ls.pdf > 0.0f)) return splat3(0.0f);
  float mis_w = area > 0.0f ? power_heuristic(ls.pdf, bsdf_pdf) : 1.0f;
  return ls.emission * f * (mis_w / ls.pdf);
}

// The per-lane state that enters a bounce (integrator PathState, minus the
// radiance sum and the alive flag, which the caller keeps).
struct PathCarry {
  V3 ro, rd, throughput;
  float prev_pdf;
  V3 prev_l;
  float prev_hit_dist;
};

// The media instantiation's state: the medium the ray travels in too.
struct MediaCarry : PathCarry {
  Medium med;
};

// Camera ray direction of pixel p (Pinhole::gen_ray with pixel_coords'
// (x/W, (H-1-y)/H)) for the sub-pixel jitter (ox, oy). Formed and normalized
// in double and rounded once, as models/camera.gen_ray does: a silhouette
// hit's gradient depends on the last bit of the ray. The unnormalized
// direction q and the screen position (sx, sy), rounded to float, are for
// the adjoint.
__device__ __forceinline__ V3 camera_ray(const SceneView& s, int p, int width, int height, float ox, float oy, V3& q,
                                         float& sx, float& sy) {
  int px = p % width, py = p / width;
  double dsx = (1.0 / width) * (double)ox + (double)px / width;
  double dsy = (1.0 / height) * (double)oy + ((double)(height - 1) - (double)py) / height;
  double qd[3];
  for (int c = 0; c < 3; ++c) {
    qd[c] = ((double)s.sv[SV_LOWER_LEFT + c] - (double)s.sv[SV_CAM_ORIGIN + c]) +
            (double)s.sv[SV_HORIZONTAL + c] * dsx + (double)s.sv[SV_VERTICAL + c] * dsy;
  }
  double len = sqrt(qd[0] * qd[0] + qd[1] * qd[1] + qd[2] * qd[2]);
  q = v3((float)qd[0], (float)qd[1], (float)qd[2]);
  sx = (float)dsx;
  sy = (float)dsy;
  return v3((float)(qd[0] / len), (float)(qd[1] / len), (float)(qd[2] / len));
}

__device__ __forceinline__ PathCarry init_carry(const SceneView& s, V3 rd, int flags) {
  PathCarry c;
  c.ro = load3(s.sv + SV_CAM_ORIGIN);
  c.rd = rd;
  c.throughput = splat3(1.0f);
  c.prev_pdf = (flags & FLAG_PRIMARY_MIS) ? 0.0f : -1.0f;
  c.prev_l = splat3(0.0f);
  c.prev_hit_dist = -1.0f;
  return c;
}

// One bounce of one path (integrator make_bounce_step on a live lane):
// closest hit, emitter pass with MIS, background, emission, alpha
// pass-through, NEE and the Disney sample that sets the next ray. Adds to
// `radiance`, advances `c`, and returns whether the path goes on. The
// uniforms of bounce d are uniform(kb)[(d*N + p)*8 + j], N = W*H.
template <class B>
__device__ __forceinline__ bool bounce(const SceneView& s, PathCarry& c, V3& radiance, int n, int p, int d,
                                       int flags, uint32_t kb0, uint32_t kb1) {
  const bool stale_gate = flags & FLAG_STALE_EMITTER_GATE;
  const bool primary_mis = flags & FLAG_PRIMARY_MIS;
  const uint64_t base = bounce_counter(n, p, d);
  const V3 ro = c.ro, rd = c.rd, throughput = c.throughput;

  V3 geo_normal;
  Material mat;
  float t = B::closest_hit(s, ro, rd, geo_normal, mat);
  bool geo_hit = isfinite(t);
  float gate_dist = geo_hit ? t : (stale_gate ? c.prev_hit_dist : INFINITY);
  EmitterHit em = sample_lights_emitter(s, ro, rd, gate_dist);
  bool hit = geo_hit || em.hit;
  if (!hit) {  // background, and the path dies
    radiance = radiance + B::background(s, rd) * throughput;
    return false;
  }
  float hit_dist = em.hit ? em.dist : gate_dist;

  finalize_material(mat);
  V3 fhp = madd3(ro, rd, hit_dist);
  bool entering = dot(geo_normal, rd) <= 0.0f;
  V3 ffnormal = entering ? geo_normal : -geo_normal;
  float eta = dot(rd, geo_normal) < 0.0f ? 1.0f / mat.ior : mat.ior;

  // Alpha pass-through: Blend by the alpha coin, Mask by the cutoff.
  bool alpha_fail = (mat.alpha_mode == 1 && uniform_at(kb0, kb1, base + 6) > mat.opacity) ||
                    (mat.alpha_mode == 2 && mat.opacity < mat.alpha_cutoff);
  bool passthru = !em.hit && alpha_fail;

  if (!passthru) radiance = radiance + mat.emission * throughput;

  if (em.hit) {  // emitter hit, MIS-weighted with the previous scatter pdf
    float mis_w = power_heuristic(fmaxf(c.prev_pdf, 0.0f), em.pdf);
    if (!primary_mis && c.prev_pdf < 0.0f) mis_w = 1.0f;
    radiance = radiance + em.emission * (mis_w * 1.0f) * throughput;
  }
  c.prev_hit_dist = hit_dist;

  if (passthru) {  // continue straight through the surface
    c.ro = madd3(fhp, rd, EPS);
    return true;
  }
  if (em.hit) return false;  // the path ends on a light

  V3 ld = direct_light<B>(s, rd, fhp, ffnormal, mat, eta, uniform_at(kb0, kb1, base + 0),
                          uniform_at(kb0, kb1, base + 1), uniform_at(kb0, kb1, base + 2));
  radiance = radiance + ld * throughput;

  BsdfSample bs = disney_sample(mat, eta, -rd, ffnormal, c.prev_l, uniform_at(kb0, kb1, base + 3),
                                uniform_at(kb0, kb1, base + 4), uniform_at(kb0, kb1, base + 5));
  c.prev_pdf = bs.pdf;
  c.prev_l = bs.l;
  if (!(bs.pdf > 0.0f)) return false;
  c.throughput = throughput * bs.f / splat3(bs.pdf);
  c.ro = madd3(fhp, bs.l, EPS);
  c.rd = bs.l;
  return true;
}

// bounce with the media segment (integrator make_bounce_step on a live lane
// of a scene with a medium), in the plain version's order: the segment
// just travelled inside the carried medium (Absorb attenuates the
// throughput, Emissive adds to the radiance); the Scatter event, a free
// flight from uniform 7 that ends before the hit, which scatters there (the
// albedo, the HG-phase NEE on uniforms 0-2, the HG continuation on 3-4) and
// does no surface work; else bounce's surface, and on a transmission the
// medium transition (into a front face: the surface's medium; out of a
// back face: vacuum). The surface's NEE and the scatter point's are one
// call of media_direct_light. The surface part repeats bounce's rather than
// share it: the media-free K1 and K3 must compile to the same machine code
// whatever this function does, and a helper shared with bounce moved their
// registers (tools/k1_pair.same_resources compares the machine code with
// another tree's).
template <class B>
__device__ __forceinline__ bool media_bounce(const SceneView& s, MediaCarry& c, V3& radiance, int n, int p, int d,
                                             int flags, uint32_t kb0, uint32_t kb1) {
  const bool stale_gate = flags & FLAG_STALE_EMITTER_GATE;
  const bool primary_mis = flags & FLAG_PRIMARY_MIS;
  const uint64_t base = bounce_counter(n, p, d);
  const V3 ro = c.ro, rd = c.rd;
  const Medium med = c.med;
  V3 throughput = c.throughput;

  V3 geo_normal;
  MediaMaterial mat;
  float t = B::closest_hit(s, ro, rd, geo_normal, mat);
  bool geo_hit = isfinite(t);
  float gate_dist = geo_hit ? t : (stale_gate ? c.prev_hit_dist : INFINITY);
  EmitterHit em = sample_lights_emitter(s, ro, rd, gate_dist);
  bool hit = geo_hit || em.hit;
  if (!hit) {  // background, and the path dies
    radiance = radiance + B::background(s, rd) * throughput;
    return false;
  }
  float hit_dist = em.hit ? em.dist : gate_dist;
  c.prev_hit_dist = hit_dist;

  if (med.type == 3) radiance = radiance + med.color * splat3(med.density * hit_dist) * throughput;
  if (med.type == 1) {
    const float ext = med.density * hit_dist;
    throughput = throughput * v3(expf(-(1.0f - med.color.x) * ext), expf(-(1.0f - med.color.y) * ext),
                                 expf(-(1.0f - med.color.z) * ext));
  }
  bool scat = false;
  V3 scatter_pos;
  if (med.type == 2 && med.density > 0.0f) {
    const float s_free = -logf(fmaxf(1.0f - uniform_at(kb0, kb1, base + 7), 1e-12f)) / fmaxf(med.density, 1e-12f);
    scat = s_free < hit_dist;
    scatter_pos = madd3(ro, rd, s_free);
  }

  V3 fhp, ffnormal;
  bool entering;
  float eta;
  if (scat) {
    throughput = throughput * med.color;
  } else {
    finalize_material(mat);
    fhp = madd3(ro, rd, hit_dist);
    entering = dot(geo_normal, rd) <= 0.0f;
    ffnormal = entering ? geo_normal : -geo_normal;
    eta = dot(rd, geo_normal) < 0.0f ? 1.0f / mat.ior : mat.ior;

    bool alpha_fail = (mat.alpha_mode == 1 && uniform_at(kb0, kb1, base + 6) > mat.opacity) ||
                      (mat.alpha_mode == 2 && mat.opacity < mat.alpha_cutoff);
    bool passthru = !em.hit && alpha_fail;

    if (!passthru) radiance = radiance + mat.emission * throughput;

    if (em.hit) {
      float mis_w = power_heuristic(fmaxf(c.prev_pdf, 0.0f), em.pdf);
      if (!primary_mis && c.prev_pdf < 0.0f) mis_w = 1.0f;
      radiance = radiance + em.emission * (mis_w * 1.0f) * throughput;
    }
    if (passthru) {
      c.ro = madd3(fhp, rd, EPS);
      c.throughput = throughput;
      return true;
    }
    if (em.hit) return false;
    scatter_pos = madd3(fhp, ffnormal, EPS);
  }

  V3 ld = media_direct_light<B>(s, rd, scatter_pos, ffnormal, mat, eta, scat, med.aniso,
                                uniform_at(kb0, kb1, base + 0), uniform_at(kb0, kb1, base + 1),
                                uniform_at(kb0, kb1, base + 2));
  radiance = radiance + ld * throughput;

  if (scat) {  // on from the scatter point along the HG sample, still inside the medium
    const V3 l = sample_hg(rd, med.aniso, uniform_at(kb0, kb1, base + 3), uniform_at(kb0, kb1, base + 4));
    c.prev_pdf = hg_phase(dot(rd, l), med.aniso);
    c.prev_l = l;
    c.throughput = throughput;
    c.ro = scatter_pos;
    c.rd = l;
    return true;
  }

  BsdfSample bs = disney_sample(mat, eta, -rd, ffnormal, c.prev_l, uniform_at(kb0, kb1, base + 3),
                                uniform_at(kb0, kb1, base + 4), uniform_at(kb0, kb1, base + 5));
  c.prev_pdf = bs.pdf;
  c.prev_l = bs.l;
  if (!(bs.pdf > 0.0f)) return false;
  c.throughput = throughput * bs.f / splat3(bs.pdf);
  c.ro = madd3(fhp, bs.l, EPS);
  c.rd = bs.l;
  if (dot(bs.l, ffnormal) < 0.0f) {  // transmitted: the medium changes
    const Medium& mm = mat.medium;
    c.med = entering ? Medium{mm.type, mm.density, mm.color, clampf(mm.aniso, -0.9f, 0.9f)} : vacuum();
  }
  return true;
}

// One sample of one pixel: camera ray plus the bounce loop, returning
// radiance. Camera uniform j of pixel p is uniform(kc)[p*2 + j]. With COUNT
// (the occupancy kernel K3) *entered is set to the bounces the path entered
// alive, the loop's trips; K1's instantiation compiles no count. With MEDIA
// (a scene with a medium) the loop runs media_bounce from vacuum.
template <class B, bool COUNT = false, bool MEDIA = false>
__device__ __forceinline__ V3 trace_sample(const SceneView& s, int p, int n, int width, int height, int depth,
                                           int flags, uint32_t kc0, uint32_t kc1, uint32_t kb0, uint32_t kb1,
                                           int* entered = nullptr) {
  V3 q;
  float sx, sy;
  V3 rd = camera_ray(s, p, width, height, uniform_at(kc0, kc1, camera_counter(p, 0)),
                     uniform_at(kc0, kc1, camera_counter(p, 1)), q, sx, sy);
  if constexpr (MEDIA) {
    MediaCarry c;
    static_cast<PathCarry&>(c) = init_carry(s, rd, flags);
    c.med = vacuum();
    V3 radiance = splat3(0.0f);
    for (int d = 0; d < depth; ++d) {
      if constexpr (COUNT) *entered = d + 1;
      if (!media_bounce<B>(s, c, radiance, n, p, d, flags, kb0, kb1)) break;
    }
    return radiance;
  } else {
    PathCarry c = init_carry(s, rd, flags);
    V3 radiance = splat3(0.0f);
    for (int d = 0; d < depth; ++d) {
      if constexpr (COUNT) *entered = d + 1;
      if (!bounce<B>(s, c, radiance, n, p, d, flags, kb0, kb1)) break;
    }
    return radiance;
  }
}

}  // namespace pt
