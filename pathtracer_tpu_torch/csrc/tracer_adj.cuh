// Reverse-mode adjoint of tracer.cuh: one sample of one pixel, under the
// detached-sampling estimator of integrator/tracer.render_frame(detach=True),
// in two steps that K2's two kernels run (megakernel_bwd.cuh).
//
// Detached (constants): the BSDF sample's local direction, half vector and
// pdf, and the light sample's direction, normal, distance and pdf. Not
// detached: light emission, the geometry through fhp and the shading frame,
// the emitter pass's pdf in the MIS weight, and the camera. Hit/miss and
// shadow-ray booleans carry no gradient.
//
// record_sample traces the path once, as tracer.cuh's bounce does, and
// writes a record a bounce (Record): the carry that enters it (PathCarry:
// ro, rd, throughput, prev_pdf, prev_l, prev_hit_dist; the radiance sum
// needs none, its cotangent is the same at every bounce) and what the
// bounce decided: the closest hit's t and winner, the light the emitter
// pass hit and its distance, the NEE's light and whether its sample faced
// the point with a clear shadow ray. adjoint_sample then walks the bounces
// in reverse from those records alone, applying each bounce's adjoint, and
// ends with the camera ray's: it intersects nothing (no closest hit, march,
// triangle loop, emitter search or shadow ray). The record path repeats
// bounce's code without the radiance (and the NEE's BSDF evaluation, which
// only the radiance reads) rather than hook into it, so the forward
// kernels' code stays their own.
//
// The media instantiation (MEDIA, a scene whose material table declares a
// medium) records media_bounce's path with the medium the ray travels in
// and whether the bounce scattered in it; its reverse sweep carries the
// medium's cotangent (density, color, anisotropy) beside those of ro, rd
// and the throughput. Detached there too: the free-flight distance, the HG
// sample's direction and its pdf.
//
// Generic over the scene backend B, as tracer.cuh is: B has tracer.cuh's
// forward hooks and these,
//   float B::closest_hit_rec(s, ro, rd, win&)  (t, +inf on a miss; the winner
//     in the backend's own terms)
//   void  B::surface(s, ro, rd, t, win, normal&, material&)  (the closest
//     hit's normal and raw material, bit for bit, from t and the winner)
//   void  B::closest_hit_adj(s, ro, rd, t, win, ct_t, ct_normal, mat_adj, g, c_ro&, c_rd&)
//     (on a ray that hit at t: the cotangents of t, the normal and the raw
//     material record, into the sink, ro and rd; mat_adj a MatAdj, or a
//     MediaMatAdj whose medium goes to the 26-scalar record)
//   void  B::background_adj(s, rd, ct, g, c_rd&)
// (AnalyticalAdj in analytical_adj.cuh, SdfAdj in sdf_adj.cuh, MeshAdj in
// mesh_adj.cuh, a plugin's adjoint struct in its own header,
// megakernel_plugin.cu).
#pragma once

#include <cstring>

#include "intersect_adj.cuh"
#include "scene_adj.cuh"
#include "tracer.cuh"

namespace pt {

// One bounce's record, REC_WORDS 32-bit words (REC_WORDS_MEDIA with the
// medium): the carry entering it (14 floats), the closest hit's t, the
// emitter pass's distance, the backend's winner and the flags (int bits),
// then, with MEDIA, the carried medium's type density color(3) anisotropy.
// The flags hold the light the emitter pass hit plus one (0: none), the
// NEE's light, whether its sample faced the point and the shadow ray was
// clear (REC_LIT), and whether the bounce scattered in its medium
// (REC_SCATTERED); REC_MAX_LIGHTS lights fit.
enum : int {
  REC_RO = 0, REC_RD = 3, REC_TP = 6, REC_PREV_PDF = 9, REC_PREV_L = 10, REC_PREV_HIT = 13,
  REC_T = 14, REC_EM_DIST = 15, REC_WIN = 16, REC_FLAGS = 17, REC_WORDS = 18,
  REC_MED = 18, REC_WORDS_MEDIA = 24,
  REC_LIGHT_MASK = 0xfff, REC_NEE_SHIFT = 12, REC_LIT = 1 << 24, REC_SCATTERED = 1 << 25,
  REC_MAX_LIGHTS = REC_LIGHT_MASK,
};

__device__ __forceinline__ float as_float(int i) {
#ifdef __CUDA_ARCH__
  return __int_as_float(i);
#else
  float f;
  std::memcpy(&f, &i, sizeof f);
  return f;
#endif
}

__device__ __forceinline__ int as_int(float f) {
#ifdef __CUDA_ARCH__
  return __float_as_int(f);
#else
  int i;
  std::memcpy(&i, &f, sizeof i);
  return i;
#endif
}

// The records of one sample of one pixel: word f of bounce d at
// base[(d * WORDS + f) * stride], so that neighbouring pixels (stride apart
// in the kernels' [sample][bounce][word][pixel] layout) are neighbouring
// addresses.
template <bool MEDIA>
struct Record {
  static constexpr int WORDS = MEDIA ? REC_WORDS_MEDIA : REC_WORDS;
  float* base;
  int stride;
  __device__ __forceinline__ float& at(int d, int f) const { return base[((size_t)d * WORDS + f) * (size_t)stride]; }
  __device__ __forceinline__ void put3(int d, int f, V3 v) const {
    at(d, f) = v.x;
    at(d, f + 1) = v.y;
    at(d, f + 2) = v.z;
  }
  __device__ __forceinline__ V3 get3(int d, int f) const { return v3(at(d, f), at(d, f + 1), at(d, f + 2)); }
};

// What a bounce decided, as its record holds it.
struct BounceHit {
  float t, em_dist;
  int win, flags;
  __device__ __forceinline__ int emitter() const { return (flags & REC_LIGHT_MASK) - 1; }
  __device__ __forceinline__ int nee_light() const { return (flags >> REC_NEE_SHIFT) & REC_LIGHT_MASK; }
  __device__ __forceinline__ bool lit() const { return (flags & REC_LIT) != 0; }
  __device__ __forceinline__ bool scattered() const { return (flags & REC_SCATTERED) != 0; }
};

template <bool MEDIA>
__device__ __forceinline__ void put_carry(const Record<MEDIA>& r, int d, const PathCarry& c) {
  r.put3(d, REC_RO, c.ro);
  r.put3(d, REC_RD, c.rd);
  r.put3(d, REC_TP, c.throughput);
  r.at(d, REC_PREV_PDF) = c.prev_pdf;
  r.put3(d, REC_PREV_L, c.prev_l);
  r.at(d, REC_PREV_HIT) = c.prev_hit_dist;
}

template <bool MEDIA>
__device__ __forceinline__ PathCarry get_carry(const Record<MEDIA>& r, int d) {
  PathCarry c;
  c.ro = r.get3(d, REC_RO);
  c.rd = r.get3(d, REC_RD);
  c.throughput = r.get3(d, REC_TP);
  c.prev_pdf = r.at(d, REC_PREV_PDF);
  c.prev_l = r.get3(d, REC_PREV_L);
  c.prev_hit_dist = r.at(d, REC_PREV_HIT);
  return c;
}

__device__ __forceinline__ void put_medium(const Record<true>& r, int d, const Medium& m) {
  r.at(d, REC_MED) = (float)m.type;
  r.at(d, REC_MED + 1) = m.density;
  r.put3(d, REC_MED + 2, m.color);
  r.at(d, REC_MED + 5) = m.aniso;
}

__device__ __forceinline__ Medium get_medium(const Record<true>& r, int d) {
  return {(int)r.at(d, REC_MED), r.at(d, REC_MED + 1), r.get3(d, REC_MED + 2), r.at(d, REC_MED + 5)};
}

template <bool MEDIA>
__device__ __forceinline__ void put_hit(const Record<MEDIA>& r, int d, float t, float em_dist, int win, int flags) {
  r.at(d, REC_T) = t;
  r.at(d, REC_EM_DIST) = em_dist;
  r.at(d, REC_WIN) = as_float(win);
  r.at(d, REC_FLAGS) = as_float(flags);
}

template <bool MEDIA>
__device__ __forceinline__ BounceHit get_hit(const Record<MEDIA>& r, int d) {
  return {r.at(d, REC_T), r.at(d, REC_EM_DIST), as_int(r.at(d, REC_WIN)), as_int(r.at(d, REC_FLAGS))};
}

// The emitter pass's search (sample_lights_emitter's loop): the closest
// light the ray hits before gate_dist, lights in order with strict <; its
// index (-1: none) and distance.
__device__ __forceinline__ int emitter_winner(const SceneView& s, V3 ro, V3 rd, float gate_dist, float& dist) {
  int win = -1;
  dist = gate_dist;
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
  return win;
}

// sample_lights_emitter's result for light `win` hit at distance d (win -1:
// no light hit), in its arithmetic.
__device__ __forceinline__ EmitterHit emitter_at(const SceneView& s, V3 ro, V3 rd, int win, float d) {
  EmitterHit e = {false, d, 0.0f, splat3(0.0f)};
  if (win < 0) return e;
  const float* lt = s.light(win);
  bool is_sph = lt[14] == 1.0f;
  V3 pos = load3(lt);
  V3 normal = is_sph ? safe_normalize(madd3(ro, rd, d) - pos) : safe_normalize(cross(load3(lt + 6), load3(lt + 9)));
  float cos_theta = dot(-rd, normal);
  float denom = lt[13] * cos_theta * (is_sph ? 0.5f : 1.0f);
  e.pdf = (d * d) / (denom != 0.0f ? denom : 1.0f);
  e.emission = load3(lt + 3);
  e.hit = true;
  return e;
}

// The NEE's light pick and shadow ray from scatter_pos (tracer.cuh
// direct_light up to its any_hit): the flags' NEE bits.
template <class B>
__device__ __forceinline__ int nee_record(const SceneView& s, V3 scatter_pos, float u_pick, float r1, float r2) {
  if (s.n_lights == 0) return 0;
  const int idx = min(max((int)(u_pick * (float)s.n_lights), 0), s.n_lights - 1);
  const LightSample ls = sample_light(s, idx, scatter_pos, r1, r2);
  const bool lit = dot(ls.direction, ls.normal) < 0.0f && !B::any_hit(s, scatter_pos, ls.direction, ls.dist - EPS);
  return (idx << REC_NEE_SHIFT) | (lit ? REC_LIT : 0);
}

// bounce() without the radiance, writing bounce d's record: advances `c`
// as bounce does and returns whether the path goes on.
template <class B>
__device__ __forceinline__ bool record_bounce(const SceneView& s, PathCarry& c, int n, int p, int d, int flags,
                                              uint32_t kb0, uint32_t kb1, const Record<false>& r) {
  put_carry(r, d, c);
  const bool stale_gate = flags & FLAG_STALE_EMITTER_GATE;
  const uint64_t base = bounce_counter(n, p, d);
  const V3 ro = c.ro, rd = c.rd, throughput = c.throughput;

  int win = 0;
  const float t = B::closest_hit_rec(s, ro, rd, win);
  const bool geo_hit = isfinite(t);
  const float gate_dist = geo_hit ? t : (stale_gate ? c.prev_hit_dist : INFINITY);
  float em_dist;
  const int em = emitter_winner(s, ro, rd, gate_dist, em_dist);
  put_hit(r, d, t, em_dist, win, em + 1);
  if (!(geo_hit || em >= 0)) return false;  // background, and the path dies
  const float hit_dist = em >= 0 ? em_dist : gate_dist;

  V3 geo_normal = splat3(0.0f);
  Material mat = default_material();
  if (geo_hit) B::surface(s, ro, rd, t, win, geo_normal, mat);
  finalize_material(mat);
  V3 fhp = madd3(ro, rd, hit_dist);
  bool entering = dot(geo_normal, rd) <= 0.0f;
  V3 ffnormal = entering ? geo_normal : -geo_normal;
  float eta = dot(rd, geo_normal) < 0.0f ? 1.0f / mat.ior : mat.ior;
  bool alpha_fail = (mat.alpha_mode == 1 && uniform_at(kb0, kb1, base + 6) > mat.opacity) ||
                    (mat.alpha_mode == 2 && mat.opacity < mat.alpha_cutoff);
  bool passthru = em < 0 && alpha_fail;
  c.prev_hit_dist = hit_dist;
  if (passthru) {
    c.ro = madd3(fhp, rd, EPS);
    return true;
  }
  if (em >= 0) return false;  // the path ends on a light

  r.at(d, REC_FLAGS) = as_float(nee_record<B>(s, madd3(fhp, ffnormal, EPS), uniform_at(kb0, kb1, base + 0),
                                              uniform_at(kb0, kb1, base + 1), uniform_at(kb0, kb1, base + 2)));
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

// media_bounce() without the radiance, writing bounce d's record (with the
// carried medium and whether it scattered): advances `c` as media_bounce
// does and returns whether the path goes on.
template <class B>
__device__ __forceinline__ bool record_media_bounce(const SceneView& s, MediaCarry& c, int n, int p, int d, int flags,
                                                    uint32_t kb0, uint32_t kb1, const Record<true>& r) {
  put_carry(r, d, c);
  put_medium(r, d, c.med);
  const bool stale_gate = flags & FLAG_STALE_EMITTER_GATE;
  const uint64_t base = bounce_counter(n, p, d);
  const V3 ro = c.ro, rd = c.rd;
  const Medium med = c.med;
  V3 throughput = c.throughput;

  int win = 0;
  const float t = B::closest_hit_rec(s, ro, rd, win);
  const bool geo_hit = isfinite(t);
  const float gate_dist = geo_hit ? t : (stale_gate ? c.prev_hit_dist : INFINITY);
  float em_dist;
  const int em = emitter_winner(s, ro, rd, gate_dist, em_dist);
  put_hit(r, d, t, em_dist, win, em + 1);
  if (!(geo_hit || em >= 0)) return false;
  const float hit_dist = em >= 0 ? em_dist : gate_dist;
  c.prev_hit_dist = hit_dist;

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

  V3 fhp, ffnormal = splat3(0.0f);
  bool entering = false;
  float eta = 1.0f;
  MediaMaterial mat;
  if (scat) {
    throughput = throughput * med.color;
  } else {
    V3 geo_normal = splat3(0.0f);
    mat = default_material();
    if (geo_hit) B::surface(s, ro, rd, t, win, geo_normal, mat);
    finalize_material(mat);
    fhp = madd3(ro, rd, hit_dist);
    entering = dot(geo_normal, rd) <= 0.0f;
    ffnormal = entering ? geo_normal : -geo_normal;
    eta = dot(rd, geo_normal) < 0.0f ? 1.0f / mat.ior : mat.ior;
    bool alpha_fail = (mat.alpha_mode == 1 && uniform_at(kb0, kb1, base + 6) > mat.opacity) ||
                      (mat.alpha_mode == 2 && mat.opacity < mat.alpha_cutoff);
    bool passthru = em < 0 && alpha_fail;
    if (passthru) {
      c.ro = madd3(fhp, rd, EPS);
      c.throughput = throughput;
      return true;
    }
    if (em >= 0) return false;
    scatter_pos = madd3(fhp, ffnormal, EPS);
  }
  r.at(d, REC_FLAGS) = as_float((em + 1) | (scat ? REC_SCATTERED : 0) |
                                nee_record<B>(s, scatter_pos, uniform_at(kb0, kb1, base + 0),
                                              uniform_at(kb0, kb1, base + 1), uniform_at(kb0, kb1, base + 2)));

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

// The record step of one sample of one pixel: the camera ray and up to
// `depth` bounces, each writing its record into r. Returns the bounces the
// path entered, the records the adjoint reads.
template <class B, bool MEDIA = false>
__device__ __forceinline__ int record_sample(const SceneView& s, int p, int n, int width, int height, int depth,
                                             int flags, uint32_t kc0, uint32_t kc1, uint32_t kb0, uint32_t kb1,
                                             const Record<MEDIA>& r) {
  V3 q;
  float sx, sy;
  V3 rd = camera_ray(s, p, width, height, uniform_at(kc0, kc1, camera_counter(p, 0)),
                     uniform_at(kc0, kc1, camera_counter(p, 1)), q, sx, sy);
  if constexpr (MEDIA) {
    MediaCarry c;
    static_cast<PathCarry&>(c) = init_carry(s, rd, flags);
    c.med = vacuum();
    for (int d = 0; d < depth; ++d) {
      if (!record_media_bounce<B>(s, c, n, p, d, flags, kb0, kb1, r)) return d + 1;
    }
  } else {
    PathCarry c = init_carry(s, rd, flags);
    for (int d = 0; d < depth; ++d) {
      if (!record_bounce<B>(s, c, n, p, d, flags, kb0, kb1, r)) return d + 1;
    }
  }
  return depth;
}

// The emitter pass's pdf and emission of light `win`, hit at distance d;
// with DIST (the media instantiation: a segment inside a medium ends at the
// light) its distance's cotangent ct_dist too.
template <bool DIST = false>
__device__ __forceinline__ void sample_lights_emitter_adj(const SceneView& s, V3 ro, V3 rd, int win, float d,
                                                          float ct_pdf, V3 ct_emission, const GradSink& g, V3& c_ro,
                                                          V3& c_rd, float ct_dist = 0.0f) {
  const float* lt = s.light(win);
  const int off = light_offset(s, win);
  const bool is_sph = lt[14] == 1.0f;
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

// The BSDF side of a NEE sample `ls` of light idx that faced the point and
// was not shadowed: ld = emission L * f * (mis / pdf), f and pdf from
// disney_eval (run once, inside its adjoint), the light sample detached;
// into the light's emission, the material's, eta's, rd's and the normal's
// cotangents. Returns ld (0 where the BSDF or the light pdf is 0).
__device__ __forceinline__ V3 bsdf_nee_adj(const SceneView& s, int idx, const LightSample& ls, V3 rd, V3 ffnormal,
                                           const Material& m, float eta, V3 ct, MatAdj& a, float& c_eta, V3& c_rd,
                                           V3& c_ffnormal, const GradSink& g) {
  const bool use_mis = s.light(idx)[13] > 0.0f;
  V3 ld = splat3(0.0f), c_vw = splat3(0.0f);
  bool on = false;
  disney_eval_with_adj(
      m, eta, -rd, ffnormal, ls.direction,
      [&](V3 f, float bsdf_pdf, V3& c_f, float& c_bpdf) {
        if (!(bsdf_pdf > 0.0f && ls.pdf > 0.0f)) return false;
        float mis_w = use_mis ? power_heuristic(ls.pdf, bsdf_pdf) : 1.0f;
        float sc = mis_w / ls.pdf;
        g.add3(light_offset(s, idx) + 3, ct * f * (sc * (float)s.n_lights));
        c_f = ct * ls.emission * sc;
        float c_mis = dot(ct, ls.emission * f) / ls.pdf;
        float c_lpdf = 0.0f;
        c_bpdf = 0.0f;
        if (use_mis) power_heuristic_adj(ls.pdf, bsdf_pdf, c_mis, c_lpdf, c_bpdf);
        ld = ls.emission * f * sc;
        on = true;
        return true;
      },
      a, c_eta, c_vw, c_ffnormal);
  if (on) c_rd -= c_vw;
  return ld;
}

// NEE: ld = emission L * f * (mis / pdf) with the light sample detached,
// for the light and the verdict the record holds (`nee`, its flags).
// Returns ld, what direct_light returns.
__device__ __forceinline__ V3 direct_light_adj(const SceneView& s, V3 rd, V3 fhp, V3 ffnormal, const Material& m,
                                               float eta, const BounceHit& h, float r1, float r2, V3 ct, MatAdj& a,
                                               float& c_eta, V3& c_rd, V3& c_ffnormal, const GradSink& g) {
  if (!h.lit()) return splat3(0.0f);  // no light, a sample facing away, or the shadow ray blocked
  V3 scatter_pos = madd3(fhp, ffnormal, EPS);
  const int idx = h.nee_light();
  LightSample ls = sample_light(s, idx, scatter_pos, r1, r2);
  return bsdf_nee_adj(s, idx, ls, rd, ffnormal, m, eta, ct, a, c_eta, c_rd, c_ffnormal, g);
}

// The media instantiation's NEE (tracer.cuh direct_light), at a
// surface (`phase` false: direct_light_adj's terms) or at a volumetric
// scatter point (`phase`: ld = L * (w p / pdf), p = hg_phase(<rd, l>, g),
// w = power_heuristic(pdf, p) for a light with area, the light sample
// detached), for the light and the verdict the record holds, into the
// material's, eta's, rd's, the normal's and g's cotangents. Returns ld,
// what direct_light returns.
__device__ __forceinline__ V3 media_direct_light_adj(const SceneView& s, V3 rd, V3 scatter_pos, V3 ffnormal,
                                                     const Material& m, float eta, bool phase, float aniso,
                                                     const BounceHit& h, float r1, float r2, V3 ct, MatAdj& a,
                                                     float& c_eta, V3& c_rd, V3& c_ffnormal, float& c_aniso,
                                                     const GradSink& g) {
  if (!h.lit()) return splat3(0.0f);
  const int idx = h.nee_light();
  LightSample ls = sample_light(s, idx, scatter_pos, r1, r2);
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
  return bsdf_nee_adj(s, idx, ls, rd, ffnormal, m, eta, ct, a, c_eta, c_rd, c_ffnormal, g);
}

// Adjoint of bounce() on the carry `c` that entered it and the record `h`
// of what it decided. On entry ct_ro, ct_rd, ct_tp hold the cotangents of
// the carry the bounce hands on (zero after the bounce where the path
// dies); on exit, those of `c`. ct_rad is the radiance cotangent.
template <class B>
__device__ __forceinline__ void bounce_adj(const SceneView& s, const PathCarry& c, const BounceHit& h, int n, int p,
                                           int d, int flags, uint32_t kb0, uint32_t kb1, V3 ct_rad, V3& ct_ro,
                                           V3& ct_rd, V3& ct_tp, const GradSink& g) {
  const bool primary_mis = flags & FLAG_PRIMARY_MIS;
  const uint64_t base = bounce_counter(n, p, d);
  const V3 ro = c.ro, rd = c.rd, tp = c.throughput;
  const V3 out_ro = ct_ro, out_rd = ct_rd, out_tp = ct_tp;
  V3 c_ro = splat3(0.0f), c_rd = splat3(0.0f), c_tp = splat3(0.0f);

  const float t = h.t;
  const bool geo_hit = isfinite(t);
  const int em_light = h.emitter();
  const EmitterHit em = emitter_at(s, ro, rd, em_light, h.em_dist);
  if (!(geo_hit || em.hit)) {  // background; the dead lane passes its carry on unchanged
    c_tp += ct_rad * B::background(s, rd);
    B::background_adj(s, rd, ct_rad * tp, g, c_rd);
    ct_ro = out_ro + c_ro;
    ct_rd = out_rd + c_rd;
    ct_tp = out_tp + c_tp;
    return;
  }
  V3 geo_normal = splat3(0.0f);
  Material mat = default_material();
  if (geo_hit) B::surface(s, ro, rd, t, h.win, geo_normal, mat);
  float hit_dist = em.hit ? em.dist : t;
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
    sample_lights_emitter_adj(s, ro, rd, em_light, em.dist, c_pdf, ct_rad * tp * mis_w, g, c_ro, c_rd);
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
    float u1 = uniform_at(kb0, kb1, base + 1), u2 = uniform_at(kb0, kb1, base + 2);
    float u3 = uniform_at(kb0, kb1, base + 3), u4 = uniform_at(kb0, kb1, base + 4);
    float u5 = uniform_at(kb0, kb1, base + 5);
    float c_eta = 0.0f;
    V3 c_ffn = splat3(0.0f);
    // radiance += ld * throughput
    c_tp += ct_rad * direct_light_adj(s, rd, fhp, ffnormal, mat, eta, h, u1, u2, ct_rad * tp, a, c_eta, c_rd, c_ffn,
                                      g);

    V3 c_fhp = splat3(0.0f), c_vw = splat3(0.0f);
    bool goes_on = false;
    disney_sample_with_adj(
        mat, eta, -rd, ffnormal, c.prev_l, u3, u4, u5,
        [&](const BsdfSample& bs, V3& c_l, V3& c_f) {
          if (!(bs.pdf > 0.0f)) return false;
          // throughput' = throughput f / pdf, ro' = fhp + l EPS, rd' = l
          c_tp += out_tp * bs.f / splat3(bs.pdf);
          c_f = out_tp * tp / splat3(bs.pdf);
          c_fhp = out_ro;
          c_l = out_rd + out_ro * EPS;
          goes_on = true;
          return true;
        },
        a, c_eta, c_vw, c_ffn);
    if (goes_on) {
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
    B::closest_hit_adj(s, ro, rd, t, h.win, c_t, c_n, a, g, c_ro, c_rd);
  }
  ct_ro = c_ro;
  ct_rd = c_rd;
  ct_tp = c_tp;
}

// Adjoint of media_bounce() on the carry `c` that entered it and the record
// `h` of what it decided, in the plain version's order: the segment inside
// the carried medium (Emissive adds color density seg tp to the radiance,
// Absorb multiplies tp by exp(-(1 - color) density seg); seg is the hit
// distance, whose cotangent goes to the geometry's t or, on a light, to the
// light's distance), the Scatter event (tp *= color; ro' = ro + rd s_free
// with s_free a constant; rd' the detached HG sample; the HG-phase NEE into
// the light's emission, rd and g), else bounce_adj's surface terms and the
// medium transition. As bounce_adj, ct_ro, ct_rd, ct_tp hold the cotangents
// of the carry the bounce hands on on entry and of `c` on exit, and ct_med
// those of its medium: they pass through a bounce that keeps the medium,
// land on the hit material's medium record on a transmission into a front
// face (through the clamp of g to [-0.9, 0.9]) and are dropped on one out
// of a back face (vacuum). The surface part repeats bounce_adj's rather
// than share it, so that the media-free K2 does not change with this
// function.
template <class B>
__device__ __forceinline__ void media_bounce_adj(const SceneView& s, const MediaCarry& c, const BounceHit& h, int n,
                                                 int p, int d, int flags, uint32_t kb0, uint32_t kb1, V3 ct_rad,
                                                 V3& ct_ro, V3& ct_rd, V3& ct_tp, MediumAdj& ct_med,
                                                 const GradSink& g) {
  const bool primary_mis = flags & FLAG_PRIMARY_MIS;
  const uint64_t base = bounce_counter(n, p, d);
  const V3 ro = c.ro, rd = c.rd, tp0 = c.throughput;
  const Medium med = c.med;
  const V3 out_ro = ct_ro, out_rd = ct_rd, out_tp = ct_tp;
  V3 c_ro = splat3(0.0f), c_rd = splat3(0.0f);

  const float t = h.t;
  const bool geo_hit = isfinite(t);
  const int em_light = h.emitter();
  const EmitterHit em = emitter_at(s, ro, rd, em_light, h.em_dist);
  if (!(geo_hit || em.hit)) {  // background; the dead lane passes its carry on unchanged
    B::background_adj(s, rd, ct_rad * tp0, g, c_rd);
    ct_ro = out_ro + c_ro;
    ct_rd = out_rd + c_rd;
    ct_tp = out_tp + ct_rad * B::background(s, rd);
    return;
  }
  float hit_dist = em.hit ? em.dist : t;

  // The segment: tp1 after Absorb, tp2 after the scatter's albedo.
  V3 tp1 = tp0, att;
  float ext = 0.0f;
  if (med.type == 1) {
    ext = med.density * hit_dist;
    att = v3(expf(-(1.0f - med.color.x) * ext), expf(-(1.0f - med.color.y) * ext),
             expf(-(1.0f - med.color.z) * ext));
    tp1 = tp0 * att;
  }
  const bool scat = h.scattered();
  float s_free = 0.0f;
  V3 scatter_pos;
  if (scat) {
    s_free = -logf(fmaxf(1.0f - uniform_at(kb0, kb1, base + 7), 1e-12f)) / fmaxf(med.density, 1e-12f);
    scatter_pos = madd3(ro, rd, s_free);
  }
  const V3 tp2 = scat ? tp1 * med.color : tp1;

  MediaMatAdj a = zero_media_mat_adj();
  MediumAdj c_med = zero_medium_adj();  // this bounce's own use of the medium
  bool keeps_medium = true;
  float c_hd = 0.0f, c_em_pdf = 0.0f;  // of hit_dist and of the emitter pass's pdf
  V3 c_tp2 = splat3(0.0f), ct_em = splat3(0.0f), c_n = splat3(0.0f);
  MediaMaterial mat;
  mat = default_material();
  V3 geo_normal = splat3(0.0f);
  if (geo_hit && !scat) B::surface(s, ro, rd, t, h.win, geo_normal, mat);
  const MediaMaterial raw = mat;
  V3 ffnormal = splat3(0.0f);  // the surface's; the scatter point's NEE reads neither
  float eta = 1.0f;
  if (scat) {  // the scatter point's NEE, then on along the detached HG sample
    float c_eta = 0.0f;
    V3 c_ffn = splat3(0.0f);
    c_tp2 += ct_rad * media_direct_light_adj(s, rd, scatter_pos, ffnormal, mat, eta, true, med.aniso, h,
                                             uniform_at(kb0, kb1, base + 1), uniform_at(kb0, kb1, base + 2),
                                             ct_rad * tp2, a, c_eta, c_rd, c_ffn, c_med.aniso, g);
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
      c_tp2 += ct_rad * media_direct_light_adj(s, rd, madd3(fhp, ffnormal, EPS), ffnormal, mat, eta, false, 0.0f, h,
                                               uniform_at(kb0, kb1, base + 1), uniform_at(kb0, kb1, base + 2),
                                               ct_rad * tp2, a, c_eta, c_rd, c_ffn, c_g, g);

      V3 c_fhp = splat3(0.0f), c_vw = splat3(0.0f);
      bool goes_on = false;
      disney_sample_with_adj(
          mat, eta, -rd, ffnormal, c.prev_l, u3, u4, u5,
          [&](const BsdfSample& bs, V3& c_l, V3& c_f) {
            if (!(bs.pdf > 0.0f)) return false;
            // throughput' = throughput f / pdf, ro' = fhp + l EPS, rd' = l
            c_tp2 += out_tp * bs.f / splat3(bs.pdf);
            c_f = out_tp * tp2 / splat3(bs.pdf);
            c_fhp = out_ro;
            c_l = out_rd + out_ro * EPS;
            if (dot(bs.l, ffnormal) < 0.0f) {  // transmitted: the medium handed on is the surface's, or vacuum
              keeps_medium = false;
              if (entering) {
                a.medium.density += ct_med.density;
                a.medium.color += ct_med.color;
                a.medium.aniso += ct_med.aniso * dclip(raw.medium.aniso, -0.9f, 0.9f);
              }
            }
            goes_on = true;
            return true;
          },
          a, c_eta, c_vw, c_ffn);
      if (goes_on) {
        c_rd -= c_vw;
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
    if (em.hit) sample_lights_emitter_adj<true>(s, ro, rd, em_light, em.dist, c_em_pdf, ct_em, g, c_ro, c_rd, c_hd);
    if (geo_hit) {  // a light seen against the sky has the default material and no surface
      finalize_material_adj(raw, a);
      B::closest_hit_adj(s, ro, rd, t, h.win, em.hit ? 0.0f : c_hd, c_n, a, g, c_ro, c_rd);
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

// The adjoint step of one sample of one pixel: adds d(<ct_rad, radiance of
// this sample>)/d(packed scene) to g, walking the `bounces` records that
// record_sample wrote in reverse and ending with the camera ray's adjoint.
// With MEDIA (a scene with a medium) each bounce is media_bounce_adj.
template <class B, bool MEDIA = false>
__device__ __forceinline__ void adjoint_sample(const SceneView& s, int p, int n, int width, int height, int flags,
                                               uint32_t kc0, uint32_t kc1, uint32_t kb0, uint32_t kb1, V3 ct_rad,
                                               const Record<MEDIA>& r, int bounces, const GradSink& g) {
  V3 q;
  float sx, sy;
  camera_ray(s, p, width, height, uniform_at(kc0, kc1, camera_counter(p, 0)),
             uniform_at(kc0, kc1, camera_counter(p, 1)), q, sx, sy);
  V3 ct_ro = splat3(0.0f), ct_rd = splat3(0.0f), ct_tp = splat3(0.0f);
  if constexpr (MEDIA) {
    MediumAdj ct_med = zero_medium_adj();  // the camera's vacuum takes none
    for (int d = bounces - 1; d >= 0; --d) {
      MediaCarry c;
      static_cast<PathCarry&>(c) = get_carry(r, d);
      c.med = get_medium(r, d);
      media_bounce_adj<B>(s, c, get_hit(r, d), n, p, d, flags, kb0, kb1, ct_rad, ct_ro, ct_rd, ct_tp, ct_med, g);
    }
  } else {
    for (int d = bounces - 1; d >= 0; --d) {
      bounce_adj<B>(s, get_carry(r, d), get_hit(r, d), n, p, d, flags, kb0, kb1, ct_rad, ct_ro, ct_rd, ct_tp, g);
    }
  }
  camera_ray_adj(q, sx, sy, ct_ro, ct_rd, g);
}

}  // namespace pt
