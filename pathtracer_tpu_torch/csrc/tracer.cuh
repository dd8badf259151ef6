// Scalar per-thread twin of integrator/tracer.py (mis estimator): emitter
// pass, light sampling, NEE and the bounce of one path, as two phases
// (`segment`, `shade`) that the per-thread loop (trace_sample) runs in turn
// and the compacted K1 (megakernel_fwd.cuh) runs over lists of a block's
// paths kept in shared memory (Tile). The media segment (Absorb, Emissive,
// HG single Scatter) is the MEDIA instantiation's (a scene whose material
// table declares a medium, as the JAX kernel's has_media); the media-free
// one compiles none of it.
//
// Generic over the scene backend B, the counterpart of the JAX package's
// KernelBackend (ops/megakernel.py): a type with static
//   float B::closest_hit(s, ro, rd, normal&, material&)  (+inf on a miss)
//   bool  B::any_hit(s, ro, rd, max_dist)
//   V3    B::background(s, rd)
// over the packed scene of scene.cuh (Analytical in analytical.cuh, Sdf in
// sdf.cuh, Mesh in mesh.cuh, BigMesh in bigmesh.cuh); its closest hit is a
// template over the material it fills (Material, MediaMaterial, MatRef).
#pragma once

#include <type_traits>

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

// Next-event estimation from scatter_pos: at a surface (integrator
// direct_light, from fhp + ffnormal * EPS) or, with `phase`, at a
// volumetric scatter point of the MEDIA instantiation (integrator
// scatter_direct_light): there the HG phase of anisotropy g is the value
// and the pdf in place of the Disney BSDF. One function for both, so the
// shadow ray (the SDF's march) is inlined once.
template <class B>
__device__ __forceinline__ V3 direct_light(const SceneView& s, V3 rd, V3 scatter_pos, V3 ffnormal, const Material& m,
                                           float eta, bool phase, float g, float u_pick, float r1, float r2) {
  if (s.n_lights == 0) return splat3(0.0f);
  // Truncation toward zero, as the reference's int cast.
  int idx = min(max((int)(u_pick * (float)s.n_lights), 0), s.n_lights - 1);
  LightSample ls = sample_light(s, idx, scatter_pos, r1, r2);
  // A failed test zeroes the contribution, so later tests are skipped.
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

template <bool MEDIA>
using Carry = std::conditional_t<MEDIA, MediaCarry, PathCarry>;
template <bool MEDIA>
using MaterialOf = std::conditional_t<MEDIA, MediaMaterial, Material>;

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

// One bounce of one path (integrator make_bounce_step on a live lane) is
// two phases, which the compacted K1 (megakernel_fwd.cuh) runs over lists
// of paths apart: `segment` ends the ray, `shade` scatters it. The
// outcomes of a segment, and of a path between two levels:
enum : int {
  DEAD = 0,     // it added its background or light and ended
  LIVE = 1,     // it goes on to the next bounce (an alpha pass-through, or a shaded path)
  SURFACE = 2,  // shade: a surface's NEE and Disney sample
  SCATTER = 3,  // shade: the MEDIA instantiation's scatter point, HG NEE and sample
};

// What a segment hands its shade: the distance to the surface (to the
// scatter point, for SCATTER), the geometric normal and the closest hit's
// material M, a Material (MediaMaterial) or a MatRef to one.
template <class M>
struct Hit {
  float t;
  V3 normal;
  M mat;
};

// The closest hit's material by reference, as the compacted K1 keeps it
// between its phases: the record's index (-1: Material::new, on a miss) and
// the albedo, which a backend's checker overrides. A backend's closest hit
// fills it as it fills a Material (load_material, then the checker's rgb);
// material_of rebuilds that Material bit for bit.
template <bool MEDIA>
struct MatRef {
  int index;
  V3 rgb;
  __device__ __forceinline__ MatRef& operator=(const Material& m) {
    index = -1;
    rgb = m.rgb;
    return *this;
  }
};

template <bool MEDIA>
__device__ __forceinline__ void load_material(const SceneView& s, int i, MatRef<MEDIA>& m) {
  m.index = i;
  m.rgb = load3(s.sv + s.lights_at + s.n_lights * LIGHT_STRIDE + i * (MEDIA ? MAT_STRIDE_MEDIA : MAT_STRIDE));
}

template <class M>
__device__ __forceinline__ M material_of(const SceneView&, const M& m) {
  return m;
}

template <bool MEDIA>
__device__ __forceinline__ MaterialOf<MEDIA> material_of(const SceneView& s, const MatRef<MEDIA>& r) {
  MaterialOf<MEDIA> m;
  if (r.index < 0) {
    m = default_material();
  } else {
    load_material(s, r.index, m);
  }
  m.rgb = r.rgb;
  return m;
}

// The segment phase of bounce d (integrator make_bounce_step up to the
// shading): the closest hit, the emitter pass, the background; in the MEDIA
// instantiation the segment just travelled inside the carried medium
// (Absorb attenuates the throughput, Emissive adds to the radiance) and the
// Scatter medium's free flight from uniform 7, which scatters if it ends
// before the hit; then the surface's emission, the emitter hit with MIS and
// the alpha pass-through (Blend by the alpha coin, Mask by the cutoff).
// Adds to `radiance`, advances `c` and returns the outcome; for SURFACE and
// SCATTER it fills `h`. The uniforms of bounce d are uniform(kb)[(d*N +
// p)*8 + j], N = W*H.
template <class B, bool MEDIA, class M>
__device__ __forceinline__ int segment(const SceneView& s, Carry<MEDIA>& c, V3& radiance, Hit<M>& h, int n, int p,
                                       int d, int flags, uint32_t kb0, uint32_t kb1) {
  const bool stale_gate = flags & FLAG_STALE_EMITTER_GATE;
  const bool primary_mis = flags & FLAG_PRIMARY_MIS;
  const uint64_t base = bounce_counter(n, p, d);
  const V3 ro = c.ro, rd = c.rd;
  V3 throughput = c.throughput;

  float t = B::closest_hit(s, ro, rd, h.normal, h.mat);
  bool geo_hit = isfinite(t);
  float gate_dist = geo_hit ? t : (stale_gate ? c.prev_hit_dist : INFINITY);
  EmitterHit em = sample_lights_emitter(s, ro, rd, gate_dist);
  if (!(geo_hit || em.hit)) {  // background, and the path dies
    radiance = radiance + B::background(s, rd) * throughput;
    return DEAD;
  }
  const float hit_dist = em.hit ? em.dist : gate_dist;
  c.prev_hit_dist = hit_dist;

  if constexpr (MEDIA) {
    const Medium med = c.med;
    if (med.type == 3) radiance = radiance + med.color * splat3(med.density * hit_dist) * throughput;
    if (med.type == 1) {
      const float ext = med.density * hit_dist;
      throughput = throughput * v3(expf(-(1.0f - med.color.x) * ext), expf(-(1.0f - med.color.y) * ext),
                                   expf(-(1.0f - med.color.z) * ext));
    }
    if (med.type == 2 && med.density > 0.0f) {
      const float s_free = -logf(fmaxf(1.0f - uniform_at(kb0, kb1, base + 7), 1e-12f)) / fmaxf(med.density, 1e-12f);
      if (s_free < hit_dist) {  // scatters there, and does no surface work
        c.throughput = throughput * med.color;
        h.t = s_free;
        return SCATTER;
      }
    }
    c.throughput = throughput;
  }

  const MaterialOf<MEDIA> mat = material_of(s, h.mat);
  bool alpha_fail = (mat.alpha_mode == 1 && uniform_at(kb0, kb1, base + 6) > mat.opacity) ||
                    (mat.alpha_mode == 2 && mat.opacity < mat.alpha_cutoff);
  bool passthru = !em.hit && alpha_fail;

  if (!passthru) radiance = radiance + mat.emission * throughput;

  if (em.hit) {  // emitter hit, MIS-weighted with the previous scatter pdf; the path ends on the light
    float mis_w = power_heuristic(fmaxf(c.prev_pdf, 0.0f), em.pdf);
    if (!primary_mis && c.prev_pdf < 0.0f) mis_w = 1.0f;
    radiance = radiance + em.emission * (mis_w * 1.0f) * throughput;
    return DEAD;
  }
  if (passthru) {  // continue straight through the surface
    c.ro = madd3(madd3(ro, rd, hit_dist), rd, EPS);
    return LIVE;
  }
  h.t = hit_dist;
  return SURFACE;
}

// The shade phase of bounce d, after a segment that returned SURFACE or, in
// the MEDIA instantiation, SCATTER (`scatter`): NEE with its shadow ray and
// the Disney sample that sets the next ray, the medium changing on a
// transmission (into a front face: the surface's medium; out of a back
// face: vacuum); at a scatter point the HG-phase NEE on uniforms 0-2 and
// the HG continuation on 3-4, still inside the medium. Adds to `radiance`,
// advances `c` and returns whether the path goes on.
template <class B, bool MEDIA, class M>
__device__ __forceinline__ bool shade(const SceneView& s, Carry<MEDIA>& c, V3& radiance, const Hit<M>& h,
                                      bool scatter, int n, int p, int d, uint32_t kb0, uint32_t kb1) {
  const uint64_t base = bounce_counter(n, p, d);
  const V3 ro = c.ro, rd = c.rd, throughput = c.throughput;
  const bool phase = MEDIA && scatter;
  float g = 0.0f;
  if constexpr (MEDIA) g = c.med.aniso;

  MaterialOf<MEDIA> mat;
  V3 fhp, ffnormal, scatter_pos;
  bool entering;
  float eta;
  if (phase) {
    scatter_pos = madd3(ro, rd, h.t);
  } else {
    mat = material_of(s, h.mat);
    finalize_material(mat);
    fhp = madd3(ro, rd, h.t);
    entering = dot(h.normal, rd) <= 0.0f;
    ffnormal = entering ? h.normal : -h.normal;
    eta = dot(rd, h.normal) < 0.0f ? 1.0f / mat.ior : mat.ior;
    scatter_pos = madd3(fhp, ffnormal, EPS);
  }

  V3 ld = direct_light<B>(s, rd, scatter_pos, ffnormal, mat, eta, phase, g, uniform_at(kb0, kb1, base + 0),
                          uniform_at(kb0, kb1, base + 1), uniform_at(kb0, kb1, base + 2));
  radiance = radiance + ld * throughput;

  if (phase) {  // on from the scatter point along the HG sample
    const V3 l = sample_hg(rd, g, uniform_at(kb0, kb1, base + 3), uniform_at(kb0, kb1, base + 4));
    c.prev_pdf = hg_phase(dot(rd, l), g);
    c.prev_l = l;
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
  if constexpr (MEDIA) {
    if (dot(bs.l, ffnormal) < 0.0f) {  // transmitted: the medium changes
      const Medium& mm = mat.medium;
      c.med = entering ? Medium{mm.type, mm.density, mm.color, clampf(mm.aniso, -0.9f, 0.9f)} : vacuum();
    }
  }
  return true;
}

// One bounce of one path, its two phases in turn (the per-thread loop of
// trace_sample; K2's record kernel follows it): adds to `radiance`,
// advances `c` and returns whether the path goes on.
template <class B, bool MEDIA = false>
__device__ __forceinline__ bool bounce(const SceneView& s, Carry<MEDIA>& c, V3& radiance, int n, int p, int d,
                                       int flags, uint32_t kb0, uint32_t kb1) {
  Hit<MaterialOf<MEDIA>> h;
  const int o = segment<B, MEDIA>(s, c, radiance, h, n, p, d, flags, kb0, kb1);
  if (o == DEAD || o == LIVE) return o == LIVE;
  return shade<B, MEDIA>(s, c, radiance, h, o == SCATTER, n, p, d, kb0, kb1);
}

// bounce of the MEDIA instantiation (a scene whose material table declares
// a medium, as the JAX kernel's has_media).
template <class B>
__device__ __forceinline__ bool media_bounce(const SceneView& s, MediaCarry& c, V3& radiance, int n, int p, int d,
                                             int flags, uint32_t kb0, uint32_t kb1) {
  return bounce<B, true>(s, c, radiance, n, p, d, flags, kb0, kb1);
}

// A sample's path before its first bounce: the camera ray of pixel p
// (camera uniform j of pixel p is uniform(kc)[p*2 + j]) from the camera, in
// vacuum.
template <bool MEDIA>
__device__ __forceinline__ Carry<MEDIA> start_path(const SceneView& s, int p, int width, int height, int flags,
                                                   uint32_t kc0, uint32_t kc1) {
  V3 q;
  float sx, sy;
  V3 rd = camera_ray(s, p, width, height, uniform_at(kc0, kc1, camera_counter(p, 0)),
                     uniform_at(kc0, kc1, camera_counter(p, 1)), q, sx, sy);
  Carry<MEDIA> c;
  static_cast<PathCarry&>(c) = init_carry(s, rd, flags);
  if constexpr (MEDIA) c.med = vacuum();
  return c;
}

// One sample of one pixel, the camera ray and the bounce loop, returning
// radiance: what one thread of the per-thread K1 runs. With COUNT (the
// occupancy kernel K3) *entered is set to the bounces the path entered
// alive, the loop's trips; K1's instantiation compiles no count. With MEDIA
// the loop runs the media instantiation's bounce.
template <class B, bool COUNT = false, bool MEDIA = false>
__device__ __forceinline__ V3 trace_sample(const SceneView& s, int p, int n, int width, int height, int depth,
                                           int flags, uint32_t kc0, uint32_t kc1, uint32_t kb0, uint32_t kb1,
                                           int* entered = nullptr) {
  Carry<MEDIA> c = start_path<MEDIA>(s, p, width, height, flags, kc0, kc1);
  V3 radiance = splat3(0.0f);
  for (int d = 0; d < depth; ++d) {
    if constexpr (COUNT) *entered = d + 1;
    if (!bounce<B, MEDIA>(s, c, radiance, n, p, d, flags, kb0, kb1)) break;
  }
  return radiance;
}

// The paths of a block's tile of P pixels, as the compacted K1 keeps them
// in shared memory: structure of arrays indexed by the pixel's place in the
// tile. Each path's carry, its radiance, what its segment hands its shade
// (Hit<MatRef>), its outcome and, for K3, the
// bounces it entered; then the list of paths a phase runs and the warps'
// counts that the block's scan sums into it (megakernel_fwd.cuh compact).
template <int P>
struct TileMedium {
  int type[P];
  float density[P], color[3][P], aniso[P];
};
struct NoMedium {};

template <bool MEDIA, int P>
struct Tile : std::conditional_t<MEDIA, TileMedium<P>, NoMedium> {
  float ro[3][P], rd[3][P], throughput[3][P], prev_l[3][P], prev_pdf[P], prev_hit_dist[P];
  float radiance[3][P];
  float t[P], normal[3][P], rgb[3][P];
  int mat[P], entered[P], list[P], counts[2 * P / 32];
  uint8_t outcome[P];
};

template <int P>
__device__ __forceinline__ V3 get3(const float (&a)[3][P], int i) {
  return v3(a[0][i], a[1][i], a[2][i]);
}

template <int P>
__device__ __forceinline__ void put3(float (&a)[3][P], int i, V3 v) {
  a[0][i] = v.x;
  a[1][i] = v.y;
  a[2][i] = v.z;
}

template <bool MEDIA, int P>
__device__ __forceinline__ Carry<MEDIA> load_path(const Tile<MEDIA, P>& t, int i) {
  Carry<MEDIA> c;
  c.ro = get3(t.ro, i);
  c.rd = get3(t.rd, i);
  c.throughput = get3(t.throughput, i);
  c.prev_pdf = t.prev_pdf[i];
  c.prev_l = get3(t.prev_l, i);
  c.prev_hit_dist = t.prev_hit_dist[i];
  if constexpr (MEDIA) c.med = {t.type[i], t.density[i], get3(t.color, i), t.aniso[i]};
  return c;
}

template <bool MEDIA, int P>
__device__ __forceinline__ void store_path(Tile<MEDIA, P>& t, int i, const Carry<MEDIA>& c) {
  put3(t.ro, i, c.ro);
  put3(t.rd, i, c.rd);
  put3(t.throughput, i, c.throughput);
  t.prev_pdf[i] = c.prev_pdf;
  put3(t.prev_l, i, c.prev_l);
  t.prev_hit_dist[i] = c.prev_hit_dist;
  if constexpr (MEDIA) {
    t.type[i] = c.med.type;
    t.density[i] = c.med.density;
    put3(t.color, i, c.med.color);
    t.aniso[i] = c.med.aniso;
  }
}

// Path i of the tile (pixel p < n, or none: DEAD) starts sample k's path.
template <bool MEDIA, int P>
__device__ __forceinline__ void start_tile_path(const SceneView& s, Tile<MEDIA, P>& t, int i, int p, int n,
                                                int width, int height, int flags, uint32_t kc0, uint32_t kc1) {
  t.outcome[i] = p < n ? LIVE : DEAD;
  t.entered[i] = 0;
  put3(t.radiance, i, splat3(0.0f));
  if (p < n) store_path(t, i, start_path<MEDIA>(s, p, width, height, flags, kc0, kc1));
}

// Path i of the tile (pixel p) enters bounce d: its segment on the tile's
// state, its outcome recorded (and with COUNT the bounces entered).
template <class B, bool COUNT, bool MEDIA, int P>
__device__ __forceinline__ void segment_tile_path(const SceneView& s, Tile<MEDIA, P>& t, int i, int p, int n, int d,
                                                  int flags, uint32_t kb0, uint32_t kb1) {
  Carry<MEDIA> c = load_path(t, i);
  V3 radiance = get3(t.radiance, i);
  Hit<MatRef<MEDIA>> h;
  const int o = segment<B, MEDIA>(s, c, radiance, h, n, p, d, flags, kb0, kb1);
  store_path(t, i, c);
  put3(t.radiance, i, radiance);
  if (o == SURFACE || o == SCATTER) {
    t.t[i] = h.t;
    put3(t.normal, i, h.normal);
    t.mat[i] = h.mat.index;
    put3(t.rgb, i, h.mat.rgb);
  }
  t.outcome[i] = (uint8_t)o;
  if constexpr (COUNT) t.entered[i] = d + 1;
}

// Path i of the tile (pixel p), whose segment at bounce d returned SURFACE
// or SCATTER: its shade on the tile's state; LIVE or DEAD after it.
template <class B, bool MEDIA, int P>
__device__ __forceinline__ void shade_tile_path(const SceneView& s, Tile<MEDIA, P>& t, int i, int p, int n, int d,
                                                uint32_t kb0, uint32_t kb1) {
  Carry<MEDIA> c = load_path(t, i);
  V3 radiance = get3(t.radiance, i);
  Hit<MatRef<MEDIA>> h;
  h.t = t.t[i];
  h.normal = get3(t.normal, i);
  h.mat.index = t.mat[i];
  h.mat.rgb = get3(t.rgb, i);
  const bool live = shade<B, MEDIA>(s, c, radiance, h, t.outcome[i] == SCATTER, n, p, d, kb0, kb1);
  store_path(t, i, c);
  put3(t.radiance, i, radiance);
  t.outcome[i] = live ? LIVE : DEAD;
}

// Path i's sample k ended: its radiance joins the sum over the pixel's
// samples in `o`, the pixel's (r, g, b, 1) in the frame.
template <bool MEDIA, int P>
__device__ __forceinline__ void end_tile_sample(const Tile<MEDIA, P>& t, int i, int k, float* o) {
  const V3 r = get3(t.radiance, i);
  const V3 sum = k == 0 ? r : v3(o[0], o[1], o[2]) + r;
  o[0] = sum.x;
  o[1] = sum.y;
  o[2] = sum.z;
  o[3] = 1.0f;
}

}  // namespace pt
