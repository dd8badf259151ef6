// Reverse-mode adjoint of tracer.cuh: one sample of one pixel, under the
// detached-sampling estimator of integrator/tracer.render_frame(detach=True).
//
// Detached (constants): the BSDF sample's local direction, half vector and
// pdf, and the light sample's direction, normal, distance and pdf. Not
// detached: light emission, the geometry through fhp and the shading frame,
// the emitter pass's pdf in the MIS weight, and the camera. Hit/miss and
// shadow-ray booleans carry no gradient.
//
// trace_sample_adj replays the path once, storing the carry that enters
// each bounce (PathCarry: ro, rd, throughput, prev_pdf, prev_l,
// prev_hit_dist; the radiance sum needs none, its cotangent is the same at
// every bounce), then walks the bounces in reverse, re-running one bounce
// at a time and applying its adjoint, and ends with the camera ray's.
//
// Generic over the scene backend B, as tracer.cuh is: B has tracer.cuh's
// forward hooks and two adjoint ones,
//   void B::closest_hit_adj(s, ro, rd, t, ct_t, ct_normal, mat_adj, g, c_ro&, c_rd&)
//     (on a ray that hit at t: the cotangents of t, the normal and the raw
//     material record, into the sink, ro and rd)
//   void B::background_adj(s, rd, ct, g, c_rd&)
// (AnalyticalAdj in analytical_adj.cuh, SdfAdj in sdf_adj.cuh).
#pragma once

#include "intersect_adj.cuh"
#include "scene_adj.cuh"
#include "tracer.cuh"

namespace pt {

constexpr int MAX_DEPTH = 16;  // carries held per thread

// The emitter pass's pdf and emission of the closest light the ray hits.
__device__ __forceinline__ void sample_lights_emitter_adj(const SceneView& s, V3 ro, V3 rd, float gate_dist,
                                                          float ct_pdf, V3 ct_emission, const GradSink& g, V3& c_ro,
                                                          V3& c_rd) {
  int win = -1;
  float dist = gate_dist;
  for (int i = 0; i < s.n_lights; ++i) {
    const float* lt = s.light(i);
    bool is_sph = lt[14] == 1.0f;
    bool is_rect = lt[14] == 0.0f;
    float d = is_sph ? ray_sphere(ro, rd, load3(lt), lt[12])
                     : (is_rect ? ray_rect(ro, rd, load3(lt), load3(lt + 6), load3(lt + 9)) : INFINITY);
    if (!(isfinite(d) && d < dist && (is_sph || is_rect))) continue;
    dist = d;
    win = i;
  }
  if (win < 0) return;
  const float* lt = s.light(win);
  const int off = light_offset(s, win);
  const bool is_sph = lt[14] == 1.0f;
  const float d = dist;
  V3 pos = load3(lt), u = load3(lt + 6), v = load3(lt + 9);
  g.add3(off + 3, ct_emission);

  V3 q = is_sph ? madd3(ro, rd, d) - pos : cross(u, v);
  V3 normal = safe_normalize(q);
  float cos_theta = dot(-rd, normal);
  float half = is_sph ? 0.5f : 1.0f;
  float denom = lt[13] * cos_theta * half;
  float dn = denom != 0.0f ? denom : 1.0f;
  float pdf = (d * d) / dn;
  float c_d = ct_pdf / dn * 2.0f * d;
  if (denom != 0.0f) {
    float c_den = -ct_pdf * pdf / denom;
    g.add(off + 13, c_den * cos_theta * half);
    float c_cos = c_den * lt[13] * half;
    c_rd -= normal * c_cos;
    V3 c_q = safe_normalize_adj(q, -rd * c_cos);
    if (is_sph) {
      g.add3(off, -c_q);
      c_ro += c_q;
      c_rd += c_q * d;
      c_d += dot(c_q, rd);
    } else {
      V3 c_u = splat3(0.0f), c_v = splat3(0.0f);
      cross_adj(u, v, c_q, c_u, c_v);
      g.add3(off + 6, c_u);
      g.add3(off + 9, c_v);
    }
  }
  V3 c_pos = splat3(0.0f);
  if (is_sph) {
    float c_radius = 0.0f;
    ray_sphere_adj(ro, rd, pos, lt[12], c_d, c_ro, c_rd, c_pos, c_radius);
    g.add(off + 12, c_radius);
  } else {
    V3 c_u = splat3(0.0f), c_v = splat3(0.0f);
    ray_rect_adj(ro, rd, pos, u, v, c_d, c_ro, c_rd, c_pos, c_u, c_v);
    g.add3(off + 6, c_u);
    g.add3(off + 9, c_v);
  }
  g.add3(off, c_pos);
}

// NEE: ld = emission L * f * (mis / pdf) with the light sample detached.
// Returns ld, what direct_light<B> returns, so the shadow ray is marched
// once.
template <class B>
__device__ __forceinline__ V3 direct_light_adj(const SceneView& s, V3 rd, V3 fhp, V3 ffnormal, const Material& m,
                                               float eta, float u_pick, float r1, float r2, V3 ct, MatAdj& a,
                                               float& c_eta, V3& c_rd, V3& c_ffnormal, const GradSink& g) {
  if (s.n_lights == 0) return splat3(0.0f);
  V3 scatter_pos = madd3(fhp, ffnormal, EPS);
  int idx = min(max((int)(u_pick * (float)s.n_lights), 0), s.n_lights - 1);
  LightSample ls = sample_light(s, idx, scatter_pos, r1, r2);
  if (!(dot(ls.direction, ls.normal) < 0.0f)) return splat3(0.0f);
  if (B::any_hit(s, scatter_pos, ls.direction, ls.dist - EPS)) return splat3(0.0f);
  float bsdf_pdf;
  V3 f = disney_eval(m, eta, -rd, ffnormal, ls.direction, bsdf_pdf);
  if (!(bsdf_pdf > 0.0f && ls.pdf > 0.0f)) return splat3(0.0f);
  bool use_mis = s.light(idx)[13] > 0.0f;
  float mis_w = use_mis ? power_heuristic(ls.pdf, bsdf_pdf) : 1.0f;
  float sc = mis_w / ls.pdf;

  g.add3(light_offset(s, idx) + 3, ct * f * (sc * (float)s.n_lights));
  V3 c_f = ct * ls.emission * sc;
  float c_mis = dot(ct, ls.emission * f) / ls.pdf;
  float c_bpdf = 0.0f, c_lpdf = 0.0f;
  if (use_mis) power_heuristic_adj(ls.pdf, bsdf_pdf, c_mis, c_lpdf, c_bpdf);
  V3 c_vw = splat3(0.0f);
  disney_eval_adj(m, eta, -rd, ffnormal, ls.direction, c_f, c_bpdf, a, c_eta, c_vw, c_ffnormal);
  c_rd -= c_vw;
  return ls.emission * f * sc;
}

// Adjoint of bounce() on the carry `c` that entered it. On entry ct_ro,
// ct_rd, ct_tp hold the cotangents of the carry the bounce hands on (zero
// after the bounce where the path dies); on exit, those of `c`. ct_rad is
// the radiance cotangent.
template <class B>
__device__ __forceinline__ void bounce_adj(const SceneView& s, const PathCarry& c, int n, int p, int d, int flags,
                                           uint32_t kb0, uint32_t kb1, V3 ct_rad, V3& ct_ro, V3& ct_rd, V3& ct_tp,
                                           const GradSink& g) {
  const bool stale_gate = flags & FLAG_STALE_EMITTER_GATE;
  const bool primary_mis = flags & FLAG_PRIMARY_MIS;
  const uint64_t base = bounce_counter(n, p, d);
  const V3 ro = c.ro, rd = c.rd, tp = c.throughput;
  const V3 out_ro = ct_ro, out_rd = ct_rd, out_tp = ct_tp;
  V3 c_ro = splat3(0.0f), c_rd = splat3(0.0f), c_tp = splat3(0.0f);

  V3 geo_normal;
  Material mat;
  float t = B::closest_hit(s, ro, rd, geo_normal, mat);
  bool geo_hit = isfinite(t);
  float gate_dist = geo_hit ? t : (stale_gate ? c.prev_hit_dist : INFINITY);
  EmitterHit em = sample_lights_emitter(s, ro, rd, gate_dist);
  if (!(geo_hit || em.hit)) {  // background; the dead lane passes its carry on unchanged
    c_tp += ct_rad * B::background(s, rd);
    B::background_adj(s, rd, ct_rad * tp, g, c_rd);
    ct_ro = out_ro + c_ro;
    ct_rd = out_rd + c_rd;
    ct_tp = out_tp + c_tp;
    return;
  }
  float hit_dist = em.hit ? em.dist : gate_dist;
  const Material raw = mat;
  finalize_material(mat);
  V3 fhp = madd3(ro, rd, hit_dist);
  bool entering = dot(geo_normal, rd) <= 0.0f;
  V3 ffnormal = entering ? geo_normal : -geo_normal;
  bool inv_ior = dot(rd, geo_normal) < 0.0f;
  float eta = inv_ior ? 1.0f / mat.ior : mat.ior;
  bool alpha_fail = (mat.alpha_mode == 1 && uniform_at(kb0, kb1, base + 6) > mat.opacity) ||
                    (mat.alpha_mode == 2 && mat.opacity < mat.alpha_cutoff);
  bool passthru = !em.hit && alpha_fail;

  MatAdj a = zero_mat_adj();
  float c_t = 0.0f;
  V3 c_n = splat3(0.0f);
  if (!passthru) {  // radiance += emission * throughput
    a.emission += ct_rad * tp;
    c_tp += ct_rad * mat.emission;
  }

  if (em.hit) {  // radiance += em.emission * mis_w * throughput; the path ends
    float pp = fmaxf(c.prev_pdf, 0.0f);
    bool weight_one = !primary_mis && c.prev_pdf < 0.0f;
    float mis_w = weight_one ? 1.0f : power_heuristic(pp, em.pdf);
    c_tp += ct_rad * em.emission * mis_w;
    float c_pdf = 0.0f, c_pp = 0.0f;
    if (!weight_one) power_heuristic_adj(pp, em.pdf, dot(ct_rad, em.emission * tp), c_pp, c_pdf);
    sample_lights_emitter_adj(s, ro, rd, gate_dist, c_pdf, ct_rad * tp * mis_w, g, c_ro, c_rd);
    c_ro += out_ro;
    c_rd += out_rd;
    c_tp += out_tp;
  } else if (passthru) {  // ro' = fhp + rd EPS, rd' = rd, throughput' = throughput
    V3 c_fhp = out_ro;
    c_rd += out_rd + out_ro * EPS;
    c_tp += out_tp;
    c_ro += c_fhp;
    c_rd += c_fhp * hit_dist;
    c_t += dot(c_fhp, rd);
  } else {
    float u0 = uniform_at(kb0, kb1, base + 0), u1 = uniform_at(kb0, kb1, base + 1);
    float u2 = uniform_at(kb0, kb1, base + 2), u3 = uniform_at(kb0, kb1, base + 3);
    float u4 = uniform_at(kb0, kb1, base + 4), u5 = uniform_at(kb0, kb1, base + 5);
    float c_eta = 0.0f;
    V3 c_ffn = splat3(0.0f);
    // radiance += ld * throughput
    c_tp += ct_rad * direct_light_adj<B>(s, rd, fhp, ffnormal, mat, eta, u0, u1, u2, ct_rad * tp, a, c_eta, c_rd,
                                         c_ffn, g);

    BsdfSample bs = disney_sample(mat, eta, -rd, ffnormal, c.prev_l, u3, u4, u5);
    V3 c_fhp = splat3(0.0f);
    if (bs.pdf > 0.0f) {  // throughput' = throughput f / pdf, ro' = fhp + l EPS, rd' = l
      c_tp += out_tp * bs.f / splat3(bs.pdf);
      V3 c_f = out_tp * tp / splat3(bs.pdf);
      c_fhp = out_ro;
      V3 c_vw = splat3(0.0f);
      disney_sample_adj(mat, eta, -rd, ffnormal, c.prev_l, u3, u4, u5, out_rd + out_ro * EPS, c_f, a, c_eta, c_vw,
                        c_ffn);
      c_rd -= c_vw;
    } else {  // the path dies here
      c_ro += out_ro;
      c_rd += out_rd;
      c_tp += out_tp;
    }
    c_ro += c_fhp;
    c_rd += c_fhp * hit_dist;
    c_t += dot(c_fhp, rd);
    a.ior += inv_ior ? -c_eta / (mat.ior * mat.ior) : c_eta;
    c_n += entering ? c_ffn : -c_ffn;
  }

  if (geo_hit) {  // a light seen against the sky has the default material and no surface
    finalize_material_adj(raw, a);
    B::closest_hit_adj(s, ro, rd, t, c_t, c_n, a, g, c_ro, c_rd);
  }
  ct_ro = c_ro;
  ct_rd = c_rd;
  ct_tp = c_tp;
}

// rd = normalize(q), q = (lower_left - origin) + horizontal sx + vertical sy;
// ro = origin.
__device__ __forceinline__ void camera_ray_adj(V3 q, float sx, float sy, V3 ct_ro, V3 ct_rd, const GradSink& g) {
  V3 c_q = normalize_adj(q, ct_rd);
  g.add3(SV_LOWER_LEFT, c_q);
  g.add3(SV_CAM_ORIGIN, ct_ro - c_q);
  g.add3(SV_HORIZONTAL, c_q * sx);
  g.add3(SV_VERTICAL, c_q * sy);
}

// Adds d(<ct_rad, radiance of this sample>)/d(packed scene) to g. depth must
// be at most MAX_DEPTH.
template <class B>
__device__ __forceinline__ void trace_sample_adj(const SceneView& s, int p, int n, int width, int height, int depth,
                                                 int flags, uint32_t kc0, uint32_t kc1, uint32_t kb0, uint32_t kb1,
                                                 V3 ct_rad, const GradSink& g) {
  V3 q;
  float sx, sy;
  V3 rd = camera_ray(s, p, width, height, uniform_at(kc0, kc1, camera_counter(p, 0)),
                     uniform_at(kc0, kc1, camera_counter(p, 1)), q, sx, sy);
  PathCarry carries[MAX_DEPTH];
  PathCarry c = init_carry(s, rd, flags);
  V3 radiance = splat3(0.0f);
  int bounces = 0;
  for (int d = 0; d < depth; ++d) {
    carries[d] = c;
    bounces = d + 1;
    if (!bounce<B>(s, c, radiance, n, p, d, flags, kb0, kb1)) break;
  }
  V3 ct_ro = splat3(0.0f), ct_rd = splat3(0.0f), ct_tp = splat3(0.0f);
  for (int d = bounces - 1; d >= 0; --d) {
    bounce_adj<B>(s, carries[d], n, p, d, flags, kb0, kb1, ct_rad, ct_ro, ct_rd, ct_tp, g);
  }
  camera_ray_adj(q, sx, sy, ct_ro, ct_rd, g);
}

}  // namespace pt
