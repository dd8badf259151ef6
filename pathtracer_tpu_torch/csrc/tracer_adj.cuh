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
// The media instantiation (trace_sample_adj<B, true>, a scene whose
// material table declares a medium) replays tracer.cuh's media_bounce and
// stores a MediaCarry a bounce (the carry and the medium the ray travels
// in); its reverse sweep carries the medium's cotangent (density, color,
// anisotropy) beside those of ro, rd and the throughput. Detached there
// too: the free-flight distance, the HG sample's direction and its pdf.
//
// Generic over the scene backend B, as tracer.cuh is: B has tracer.cuh's
// forward hooks and two adjoint ones,
//   void B::closest_hit_adj(s, ro, rd, t, ct_t, ct_normal, mat_adj, g, c_ro&, c_rd&)
//     (on a ray that hit at t: the cotangents of t, the normal and the raw
//     material record, into the sink, ro and rd; mat_adj a MatAdj, or a
//     MediaMatAdj whose medium goes to the 26-scalar record)
//   void B::background_adj(s, rd, ct, g, c_rd&)
// (AnalyticalAdj in analytical_adj.cuh, SdfAdj in sdf_adj.cuh, MeshAdj in
// mesh_adj.cuh).
#pragma once

#include "intersect_adj.cuh"
#include "scene_adj.cuh"
#include "tracer.cuh"

namespace pt {

constexpr int MAX_DEPTH = 16;  // carries held per thread

// The emitter pass's pdf and emission of the closest light the ray hits;
// with DIST (the media instantiation: a segment inside a medium ends at the
// light) its distance's cotangent ct_dist too.
template <bool DIST = false>
__device__ __forceinline__ void sample_lights_emitter_adj(const SceneView& s, V3 ro, V3 rd, float gate_dist,
                                                          float ct_pdf, V3 ct_emission, const GradSink& g, V3& c_ro,
                                                          V3& c_rd, float ct_dist = 0.0f) {
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
  if constexpr (DIST) c_d += ct_dist;
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

// The media instantiation's NEE (tracer.cuh media_direct_light), at a
// surface (`phase` false: direct_light_adj's terms) or at a volumetric
// scatter point (`phase`: ld = L * (w p / pdf), p = hg_phase(<rd, l>, g),
// w = power_heuristic(pdf, p) for a light with area, the light sample
// detached), into the material's, eta's, rd's, the normal's and g's
// cotangents. Returns ld, what media_direct_light returns, so the shadow
// ray is marched once.
template <class B>
__device__ __forceinline__ V3 media_direct_light_adj(const SceneView& s, V3 rd, V3 scatter_pos, V3 ffnormal,
                                                     const Material& m, float eta, bool phase, float aniso,
                                                     float u_pick, float r1, float r2, V3 ct, MatAdj& a,
                                                     float& c_eta, V3& c_rd, V3& c_ffnormal, float& c_aniso,
                                                     const GradSink& g) {
  if (s.n_lights == 0) return splat3(0.0f);
  int idx = min(max((int)(u_pick * (float)s.n_lights), 0), s.n_lights - 1);
  LightSample ls = sample_light(s, idx, scatter_pos, r1, r2);
  if (!(dot(ls.direction, ls.normal) < 0.0f)) return splat3(0.0f);
  if (B::any_hit(s, scatter_pos, ls.direction, ls.dist - EPS)) return splat3(0.0f);
  bool use_mis = s.light(idx)[13] > 0.0f;
  if (phase) {
    float cos_theta = dot(rd, ls.direction);
    float p = hg_phase(cos_theta, aniso);
    if (!(p > 0.0f && ls.pdf > 0.0f)) return splat3(0.0f);
    float mis_w = use_mis ? power_heuristic(ls.pdf, p) : 1.0f;
    float sc = mis_w * p / ls.pdf;
    g.add3(light_offset(s, idx) + 3, ct * (sc * (float)s.n_lights));
    float c_wp = dot(ct, ls.emission) / ls.pdf;  // of mis_w * p
    float c_p = c_wp * mis_w, c_lpdf = 0.0f, c_cos = 0.0f;
    if (use_mis) power_heuristic_adj(ls.pdf, p, c_wp * p, c_lpdf, c_p);
    hg_phase_adj(cos_theta, aniso, c_p, c_cos, c_aniso);
    c_rd += ls.direction * c_cos;
    return ls.emission * splat3(sc);
  }
  float bsdf_pdf;
  V3 f = disney_eval(m, eta, -rd, ffnormal, ls.direction, bsdf_pdf);
  if (!(bsdf_pdf > 0.0f && ls.pdf > 0.0f)) return splat3(0.0f);
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

// Adjoint of media_bounce() on the carry `c` that entered it, in the plain
// version's order: the segment inside the carried medium (Emissive adds
// color density seg tp to the radiance, Absorb multiplies tp by
// exp(-(1 - color) density seg); seg is the hit distance, whose cotangent
// goes to the geometry's t or, on a light, to the light's distance), the
// Scatter event (tp *= color; ro' = ro + rd s_free with s_free a constant;
// rd' the detached HG sample; the HG-phase NEE into the light's emission,
// rd and g), else bounce_adj's surface terms and the medium transition. As
// bounce_adj, ct_ro, ct_rd, ct_tp hold the cotangents of the carry the
// bounce hands on on entry and of `c` on exit, and ct_med those of its
// medium: they pass through a bounce that keeps the medium, land on the hit
// material's medium record on a transmission into a front face (through
// the clamp of g to [-0.9, 0.9]) and are dropped on one out of a back face
// (vacuum). The surface part repeats bounce_adj's rather than share it, so
// that the media-free K2 compiles to the same machine code whatever this
// function does (as tracer.cuh's media_bounce does for K1).
template <class B>
__device__ __forceinline__ void media_bounce_adj(const SceneView& s, const MediaCarry& c, int n, int p, int d,
                                                 int flags, uint32_t kb0, uint32_t kb1, V3 ct_rad, V3& ct_ro,
                                                 V3& ct_rd, V3& ct_tp, MediumAdj& ct_med, const GradSink& g) {
  const bool stale_gate = flags & FLAG_STALE_EMITTER_GATE;
  const bool primary_mis = flags & FLAG_PRIMARY_MIS;
  const uint64_t base = bounce_counter(n, p, d);
  const V3 ro = c.ro, rd = c.rd, tp0 = c.throughput;
  const Medium med = c.med;
  const V3 out_ro = ct_ro, out_rd = ct_rd, out_tp = ct_tp;
  V3 c_ro = splat3(0.0f), c_rd = splat3(0.0f);

  V3 geo_normal;
  MediaMaterial mat;
  float t = B::closest_hit(s, ro, rd, geo_normal, mat);
  bool geo_hit = isfinite(t);
  float gate_dist = geo_hit ? t : (stale_gate ? c.prev_hit_dist : INFINITY);
  EmitterHit em = sample_lights_emitter(s, ro, rd, gate_dist);
  if (!(geo_hit || em.hit)) {  // background; the dead lane passes its carry on unchanged
    B::background_adj(s, rd, ct_rad * tp0, g, c_rd);
    ct_ro = out_ro + c_ro;
    ct_rd = out_rd + c_rd;
    ct_tp = out_tp + ct_rad * B::background(s, rd);
    return;
  }
  float hit_dist = em.hit ? em.dist : gate_dist;

  // The segment: tp1 after Absorb, tp2 after the scatter's albedo.
  V3 tp1 = tp0, att;
  float ext = 0.0f;
  if (med.type == 1) {
    ext = med.density * hit_dist;
    att = v3(expf(-(1.0f - med.color.x) * ext), expf(-(1.0f - med.color.y) * ext),
             expf(-(1.0f - med.color.z) * ext));
    tp1 = tp0 * att;
  }
  bool scat = false;
  float s_free = 0.0f;
  V3 scatter_pos;
  if (med.type == 2 && med.density > 0.0f) {
    s_free = -logf(fmaxf(1.0f - uniform_at(kb0, kb1, base + 7), 1e-12f)) / fmaxf(med.density, 1e-12f);
    scat = s_free < hit_dist;
    scatter_pos = madd3(ro, rd, s_free);
  }
  const V3 tp2 = scat ? tp1 * med.color : tp1;

  MediaMatAdj a = zero_media_mat_adj();
  MediumAdj c_med = zero_medium_adj();  // this bounce's own use of the medium
  bool keeps_medium = true;
  float c_hd = 0.0f, c_em_pdf = 0.0f;  // of hit_dist and of the emitter pass's pdf
  V3 c_tp2 = splat3(0.0f), ct_em = splat3(0.0f), c_n = splat3(0.0f);
  const MediaMaterial raw = mat;
  V3 ffnormal = splat3(0.0f);  // the surface's; the scatter point's NEE reads neither
  float eta = 1.0f;
  if (scat) {  // the scatter point's NEE, then on along the detached HG sample
    float c_eta = 0.0f;
    V3 c_ffn = splat3(0.0f);
    c_tp2 += ct_rad * media_direct_light_adj<B>(s, rd, scatter_pos, ffnormal, mat, eta, true, med.aniso,
                                                uniform_at(kb0, kb1, base + 0), uniform_at(kb0, kb1, base + 1),
                                                uniform_at(kb0, kb1, base + 2), ct_rad * tp2, a, c_eta, c_rd,
                                                c_ffn, c_med.aniso, g);
    c_tp2 += out_tp;
    c_ro += out_ro;
    c_rd += out_ro * s_free;
  } else {
    finalize_material(mat);
    V3 fhp = madd3(ro, rd, hit_dist);
    bool entering = dot(geo_normal, rd) <= 0.0f;
    ffnormal = entering ? geo_normal : -geo_normal;
    bool inv_ior = dot(rd, geo_normal) < 0.0f;
    eta = inv_ior ? 1.0f / mat.ior : mat.ior;
    bool alpha_fail = (mat.alpha_mode == 1 && uniform_at(kb0, kb1, base + 6) > mat.opacity) ||
                      (mat.alpha_mode == 2 && mat.opacity < mat.alpha_cutoff);
    bool passthru = !em.hit && alpha_fail;

    if (!passthru) {  // radiance += emission * throughput
      a.emission += ct_rad * tp2;
      c_tp2 += ct_rad * mat.emission;
    }

    if (em.hit) {  // radiance += em.emission * mis_w * throughput; the path ends
      float pp = fmaxf(c.prev_pdf, 0.0f);
      bool weight_one = !primary_mis && c.prev_pdf < 0.0f;
      float mis_w = weight_one ? 1.0f : power_heuristic(pp, em.pdf);
      c_tp2 += ct_rad * em.emission * mis_w;
      float c_pp = 0.0f;
      if (!weight_one) power_heuristic_adj(pp, em.pdf, dot(ct_rad, em.emission * tp2), c_pp, c_em_pdf);
      ct_em = ct_rad * tp2 * mis_w;
      c_ro += out_ro;
      c_rd += out_rd;
      c_tp2 += out_tp;
    } else if (passthru) {  // ro' = fhp + rd EPS, rd' = rd, throughput' = throughput
      V3 c_fhp = out_ro;
      c_rd += out_rd + out_ro * EPS;
      c_tp2 += out_tp;
      c_ro += c_fhp;
      c_rd += c_fhp * hit_dist;
      c_hd += dot(c_fhp, rd);
    } else {
      float u3 = uniform_at(kb0, kb1, base + 3), u4 = uniform_at(kb0, kb1, base + 4);
      float u5 = uniform_at(kb0, kb1, base + 5);
      float c_eta = 0.0f, c_g = 0.0f;
      V3 c_ffn = splat3(0.0f);
      // radiance += ld * throughput
      c_tp2 += ct_rad * media_direct_light_adj<B>(s, rd, madd3(fhp, ffnormal, EPS), ffnormal, mat, eta, false,
                                                  0.0f, uniform_at(kb0, kb1, base + 0),
                                                  uniform_at(kb0, kb1, base + 1), uniform_at(kb0, kb1, base + 2),
                                                  ct_rad * tp2, a, c_eta, c_rd, c_ffn, c_g, g);

      BsdfSample bs = disney_sample(mat, eta, -rd, ffnormal, c.prev_l, u3, u4, u5);
      V3 c_fhp = splat3(0.0f);
      if (bs.pdf > 0.0f) {  // throughput' = throughput f / pdf, ro' = fhp + l EPS, rd' = l
        c_tp2 += out_tp * bs.f / splat3(bs.pdf);
        V3 c_f = out_tp * tp2 / splat3(bs.pdf);
        c_fhp = out_ro;
        V3 c_vw = splat3(0.0f);
        disney_sample_adj(mat, eta, -rd, ffnormal, c.prev_l, u3, u4, u5, out_rd + out_ro * EPS, c_f, a, c_eta, c_vw,
                          c_ffn);
        c_rd -= c_vw;
        if (dot(bs.l, ffnormal) < 0.0f) {  // transmitted: the medium handed on is the surface's, or vacuum
          keeps_medium = false;
          if (entering) {
            a.medium.density += ct_med.density;
            a.medium.color += ct_med.color;
            a.medium.aniso += ct_med.aniso * dclip(raw.medium.aniso, -0.9f, 0.9f);
          }
        }
      } else {  // the path dies here
        c_ro += out_ro;
        c_rd += out_rd;
        c_tp2 += out_tp;
      }
      c_ro += c_fhp;
      c_rd += c_fhp * hit_dist;
      c_hd += dot(c_fhp, rd);
      a.ior += inv_ior ? -c_eta / (mat.ior * mat.ior) : c_eta;
      c_n += entering ? c_ffn : -c_ffn;
    }
  }

  // The segment's terms in reverse: the albedo, Absorb, Emissive.
  V3 c_tp1 = c_tp2;
  if (scat) {
    c_tp1 = c_tp2 * med.color;
    c_med.color += c_tp2 * tp1;
  }
  V3 c_tp0 = c_tp1;
  if (med.type == 1) {
    c_tp0 = c_tp1 * att;
    const V3 q = c_tp1 * tp0 * att;  // of the exponents
    c_med.color += q * ext;
    const float c_ext = -(q.x * (1.0f - med.color.x) + q.y * (1.0f - med.color.y) + q.z * (1.0f - med.color.z));
    c_med.density += c_ext * hit_dist;
    c_hd += c_ext * med.density;
  }
  if (med.type == 3) {  // radiance += color (density seg) throughput
    const float k = med.density * hit_dist;
    const V3 c_col = ct_rad * tp0;
    const float c_k = dot(c_col, med.color);
    c_med.color += c_col * k;
    c_tp0 += ct_rad * med.color * k;
    c_med.density += c_k * hit_dist;
    c_hd += c_k * med.density;
  }

  if (!scat) {
    if (em.hit) sample_lights_emitter_adj<true>(s, ro, rd, gate_dist, c_em_pdf, ct_em, g, c_ro, c_rd, c_hd);
    if (geo_hit) {  // a light seen against the sky has the default material and no surface
      finalize_material_adj(raw, a);
      B::closest_hit_adj(s, ro, rd, t, em.hit ? 0.0f : c_hd, c_n, a, g, c_ro, c_rd);
    }
  }
  ct_ro = c_ro;
  ct_rd = c_rd;
  ct_tp = c_tp0;
  if (keeps_medium) {
    c_med.density += ct_med.density;
    c_med.color += ct_med.color;
    c_med.aniso += ct_med.aniso;
  }
  ct_med = c_med;
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
// be at most MAX_DEPTH. With MEDIA (a scene with a medium) the sweep replays
// media_bounce from vacuum and runs media_bounce_adj.
template <class B, bool MEDIA = false>
__device__ __forceinline__ void trace_sample_adj(const SceneView& s, int p, int n, int width, int height, int depth,
                                                 int flags, uint32_t kc0, uint32_t kc1, uint32_t kb0, uint32_t kb1,
                                                 V3 ct_rad, const GradSink& g) {
  V3 q;
  float sx, sy;
  V3 rd = camera_ray(s, p, width, height, uniform_at(kc0, kc1, camera_counter(p, 0)),
                     uniform_at(kc0, kc1, camera_counter(p, 1)), q, sx, sy);
  if constexpr (MEDIA) {
    MediaCarry carries[MAX_DEPTH];
    MediaCarry c;
    static_cast<PathCarry&>(c) = init_carry(s, rd, flags);
    c.med = vacuum();
    V3 radiance = splat3(0.0f);
    int bounces = 0;
    for (int d = 0; d < depth; ++d) {
      carries[d] = c;
      bounces = d + 1;
      if (!media_bounce<B>(s, c, radiance, n, p, d, flags, kb0, kb1)) break;
    }
    V3 ct_ro = splat3(0.0f), ct_rd = splat3(0.0f), ct_tp = splat3(0.0f);
    MediumAdj ct_med = zero_medium_adj();  // the camera's vacuum takes none
    for (int d = bounces - 1; d >= 0; --d) {
      media_bounce_adj<B>(s, carries[d], n, p, d, flags, kb0, kb1, ct_rad, ct_ro, ct_rd, ct_tp, ct_med, g);
    }
    camera_ray_adj(q, sx, sy, ct_ro, ct_rd, g);
  } else {
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
}

}  // namespace pt
