// Reverse-mode adjoint of the SDF backend (sdf.cuh): K5 inside K2. Port of
// what jax.vjp differentiates in pathtracer_tpu/ops/megakernel_sdf.py
// (_distances, _sdf, _normal, the Newton reattachment of _sphere_trace,
// _closest_hit_sdf, _checker, _background_sdf), held to torch autograd of
// models/sdf.
//
// The closest hit at the marched t* (the march itself runs detached) is
//
//   t = t* - (f(ro + rd t*; theta) - sg(f)) / <rd, n*>   (|<rd, n*>| > 1e-4)
//   x = ro + rd t,  normal = safe_normalize(grad_x f(x; theta))
//
// with n* the detached normal at x and f the smooth union of the
// primitives. Its adjoint needs grad_theta f and grad_x f (the Newton step)
// and, for the normal, the second derivatives H c and d^2 f/(d theta dx) c
// along c = the cotangent of grad_x f. Both come from one pass in forward
// mode: with x carrying the tangent c (Dual), the tangents of grad_x f and
// of each record derivative d f / d theta_j are H c and the mixed
// derivatives along c (their symmetry is what lets a tangent stand for a
// cotangent). jax.grad's shares at ties (maximum/minimum 0.5, abs +1 at 0,
// safe_sqrt 0 at 0, the clip edges) are constants with no tangent, as their
// own derivative is 0 in the plain version. The union is folded forward,
// storing each step's share of the running union and its derivative in
// smooth_k; a reverse pass turns them into each primitive's weight in the
// union and adds weight x record derivative, value and tangent, to the sink.
//
// No gradient flows through the march, the hit test, the material argmin
// or the checker's floor; _any_hit_sdf is boolean and has no adjoint. This
// code may round freely: only the march must replay K1's steps, and K2's
// record kernel runs sdf.cuh's sdf_march as K1 does; the adjoint reads the
// marched t and the nearest primitive from its record and marches nothing.
#pragma once

#include "scene_adj.cuh"
#include "sdf.cuh"

namespace pt {

constexpr int SDF_MAX_PRIMS = 16;  // primitives (plane included) the adjoint's union holds
constexpr float NEWTON_GATE = 1e-4f;

// A value and its tangent along the direction x carries.
struct Dual {
  float v, t;
};

__device__ __forceinline__ Dual dconst(float v) { return {v, 0.0f}; }
__device__ __forceinline__ Dual operator+(Dual a, Dual b) { return {a.v + b.v, a.t + b.t}; }
__device__ __forceinline__ Dual operator-(Dual a, Dual b) { return {a.v - b.v, a.t - b.t}; }
__device__ __forceinline__ Dual operator-(Dual a) { return {-a.v, -a.t}; }
__device__ __forceinline__ Dual operator*(Dual a, Dual b) { return {a.v * b.v, a.v * b.t + a.t * b.v}; }
__device__ __forceinline__ Dual operator/(Dual a, Dual b) { return {a.v / b.v, (a.t * b.v - a.v * b.t) / (b.v * b.v)}; }
__device__ __forceinline__ Dual operator+(Dual a, float s) { return {a.v + s, a.t}; }
__device__ __forceinline__ Dual operator-(Dual a, float s) { return {a.v - s, a.t}; }
__device__ __forceinline__ Dual operator-(float s, Dual a) { return {s - a.v, -a.t}; }
__device__ __forceinline__ Dual operator*(Dual a, float s) { return {a.v * s, a.t * s}; }

__device__ __forceinline__ Dual dsqrt(Dual a) {
  float r = sqrtf(a.v);
  return {r, a.t * 0.5f / r};
}
// safe_sqrt and safe_inv: 0, with tangent 0, where the argument is not > 0.
__device__ __forceinline__ Dual dsafe_sqrt(Dual a) { return a.v > 0.0f ? dsqrt(a) : dconst(0.0f); }
__device__ __forceinline__ Dual dsafe_inv(Dual a) {
  if (!(a.v > 0.0f)) return dconst(0.0f);
  float inv = 1.0f / a.v;
  return {inv, -a.t * inv * inv};
}
// maximum(a, b) with jax.grad's shares (0.5 each at a tie).
__device__ __forceinline__ Dual dmaximum(Dual a, Dual b) {
  float w = share(a.v > b.v, a.v == b.v);
  return {fmaxf(a.v, b.v), w * a.t + (1.0f - w) * b.t};
}

struct DV3 {
  Dual x, y, z;
};

__device__ __forceinline__ DV3 dv3(V3 v, V3 t) { return {{v.x, t.x}, {v.y, t.y}, {v.z, t.z}}; }
__device__ __forceinline__ DV3 dconst3(V3 v) { return dv3(v, splat3(0.0f)); }
__device__ __forceinline__ V3 value(DV3 a) { return v3(a.x.v, a.y.v, a.z.v); }
__device__ __forceinline__ V3 tangent(DV3 a) { return v3(a.x.t, a.y.t, a.z.t); }
__device__ __forceinline__ DV3 operator-(DV3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ DV3 operator+(DV3 a, DV3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ DV3 operator*(DV3 a, Dual s) { return {a.x * s, a.y * s, a.z * s}; }
__device__ __forceinline__ Dual ddot(DV3 a, DV3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }

// One primitive at x: its distance, its gradient in x, and its derivative
// in each entry of its record (rec[j] for entry j), all carrying x's
// tangent.
struct PrimGrad {
  Dual d;
  DV3 g;
  Dual rec[7];
  int off, stride;  // the record in the packed scene
};

__device__ __forceinline__ void sphere_grad(DV3 x, const float* r, PrimGrad& o) {
  DV3 q = x - load3(r);
  Dual len = dsqrt(ddot(q, q));
  o.d = len - r[3];
  o.g = {q.x / len, q.y / len, q.z / len};
  o.rec[0] = -o.g.x, o.rec[1] = -o.g.y, o.rec[2] = -o.g.z;
  o.rec[3] = dconst(-1.0f);
}

__device__ __forceinline__ void round_box_grad(DV3 x, const float* r, PrimGrad& o) {
  DV3 rel = x - load3(r);
  // jnp.abs's slope is +1 at 0
  const V3 sgn = v3(rel.x.v >= 0.0f ? 1.0f : -1.0f, rel.y.v >= 0.0f ? 1.0f : -1.0f, rel.z.v >= 0.0f ? 1.0f : -1.0f);
  DV3 q = {rel.x * sgn.x - r[3], rel.y * sgn.y - r[4], rel.z * sgn.z - r[5]};
  const V3 pos = v3(share(q.x.v > 0.0f, q.x.v == 0.0f), share(q.y.v > 0.0f, q.y.v == 0.0f),
                    share(q.z.v > 0.0f, q.z.v == 0.0f));
  DV3 out = {{fmaxf(q.x.v, 0.0f), pos.x * q.x.t}, {fmaxf(q.y.v, 0.0f), pos.y * q.y.t},
             {fmaxf(q.z.v, 0.0f), pos.z * q.z.t}};
  Dual out_len = dsafe_sqrt(ddot(out, out));
  Dual inv_len = dsafe_inv(out_len);
  Dual m_yz = dmaximum(q.y, q.z);
  Dual m = dmaximum(q.x, m_yz);
  float w_in = share(m.v < 0.0f, m.v == 0.0f);
  o.d = out_len + Dual{fminf(m.v, 0.0f), w_in * m.t} - r[6];
  // d f / d q_c: the outside length's and the inner minimum's shares
  float wx = share(q.x.v > m_yz.v, q.x.v == m_yz.v);
  float w_yz = share(q.y.v > q.z.v, q.y.v == q.z.v);
  Dual fx = out.x * inv_len * pos.x + w_in * wx;
  Dual fy = out.y * inv_len * pos.y + w_in * (1.0f - wx) * w_yz;
  Dual fz = out.z * inv_len * pos.z + w_in * (1.0f - wx) * (1.0f - w_yz);
  o.g = {fx * sgn.x, fy * sgn.y, fz * sgn.z};
  o.rec[0] = -o.g.x, o.rec[1] = -o.g.y, o.rec[2] = -o.g.z;
  o.rec[3] = -fx, o.rec[4] = -fy, o.rec[5] = -fz;
  o.rec[6] = dconst(-1.0f);
}

__device__ __forceinline__ void torus_grad(DV3 x, const float* r, PrimGrad& o) {
  DV3 q = x - load3(r);
  Dual s_a = dsafe_sqrt(q.x * q.x + q.z * q.z);
  Dual ring = s_a - r[3];
  Dual s_b = dsafe_sqrt(ring * ring + q.y * q.y);
  Dual inv_a = dsafe_inv(s_a), inv_b = dsafe_inv(s_b);
  Dual ring_b = ring * inv_b;
  o.d = s_b - r[4];
  o.g = {q.x * inv_a * ring_b, q.y * inv_b, q.z * inv_a * ring_b};
  o.rec[0] = -o.g.x, o.rec[1] = -o.g.y, o.rec[2] = -o.g.z;
  o.rec[3] = -ring_b;
  o.rec[4] = dconst(-1.0f);
}

__device__ __forceinline__ void plane_grad(DV3 x, const float* r, PrimGrad& o) {
  DV3 rel = x - load3(r);
  V3 n = load3(r + 3);
  o.d = ddot(rel, dconst3(n));
  o.g = dconst3(n);
  o.rec[0] = dconst(-n.x), o.rec[1] = dconst(-n.y), o.rec[2] = dconst(-n.z);
  o.rec[3] = rel.x, o.rec[4] = rel.y, o.rec[5] = rel.z;
}

// Primitive i in material-table order (spheres, boxes, tori, the plane).
__device__ __forceinline__ PrimGrad prim_grad(const SceneView& s, int i, DV3 x) {
  PrimGrad o;
  int off = SDF_PRIMS;
  if (i < s.n_spheres) {
    o.off = off + Sphere::STRIDE * i, o.stride = Sphere::STRIDE;
    sphere_grad(x, s.sv + o.off, o);
    return o;
  }
  off += Sphere::STRIDE * s.n_spheres, i -= s.n_spheres;
  if (i < s.n_boxes) {
    o.off = off + RoundBox::STRIDE * i, o.stride = RoundBox::STRIDE;
    round_box_grad(x, s.sv + o.off, o);
    return o;
  }
  off += RoundBox::STRIDE * s.n_boxes, i -= s.n_boxes;
  if (i < s.n_tori) {
    o.off = off + Torus::STRIDE * i, o.stride = Torus::STRIDE;
    torus_grad(x, s.sv + o.off, o);
    return o;
  }
  o.off = off + Torus::STRIDE * s.n_tori, o.stride = 6;
  plane_grad(x, s.sv + o.off, o);
  return o;
}

// Forward fold: returns grad_x f with H c; w[i] is union step i's share of
// the running union (d union_i / d union_{i-1}; 1 - w[i] is primitive i's),
// kd[i] its derivative in smooth_k.
__device__ __forceinline__ DV3 sdf_union_forward(const SceneView& s, DV3 x, int n, Dual* w, Dual* kd) {
  const float k = sdf_plane(s)[6];
  PrimGrad p = prim_grad(s, 0, x);
  Dual u = p.d;
  DV3 grad = p.g;
  for (int i = 1; i < n; ++i) {
    p = prim_grad(s, i, x);
    Dual wi, kdi;
    if (k > 0.0f) {  // h = clip(0.5 + 0.5 (b - a) / k, 0, 1); smin's d/dh is 0 where h moves
      float z = 0.5f + 0.5f * (p.d.v - u.v) / k;
      float h = clampf(z, 0.0f, 1.0f);
      float h_t = dclip(z, 0.0f, 1.0f) * 0.5f * (p.d.t - u.t) / k;
      wi = {h, h_t};
      kdi = {-h * (1.0f - h), -(1.0f - 2.0f * h) * h_t};
      u = {smooth_min(u.v, p.d.v, k), h * u.t + (1.0f - h) * p.d.t};
    } else {  // the hard minimum, with its tie shares
      float sh = share(u.v < p.d.v, u.v == p.d.v);
      wi = dconst(sh);
      kdi = dconst(0.0f);
      u = {fminf(u.v, p.d.v), sh * u.t + (1.0f - sh) * p.d.t};
    }
    grad = grad * wi + p.g * (1.0f - wi);
    w[i] = wi;
    kd[i] = kdi;
  }
  return grad;
}

// Reverse pass: adds c_f d f / d theta + (d f / d theta)' to the sink, the
// prime the tangent along x's direction. Primitive i's weight in the union
// is (1 - w[i]) times the later steps' w (w[0] := 0).
__device__ __forceinline__ void sdf_union_reverse(const SceneView& s, DV3 x, int n, const Dual* w, const Dual* kd,
                                                  float c_f, const GradSink& g) {
  Dual later = dconst(1.0f), dk = dconst(0.0f);
  for (int i = n - 1; i >= 0; --i) {
    Dual weight = i > 0 ? (1.0f - w[i]) * later : later;
    if (i > 0) {
      dk = dk + kd[i] * later;
      later = later * w[i];
    }
    if (weight.v == 0.0f && weight.t == 0.0f) continue;
    const PrimGrad p = prim_grad(s, i, x);
    const float alpha = c_f * weight.v + weight.t, beta = weight.v;
    for (int j = 0; j < p.stride; ++j) g.add(p.off + j, alpha * p.rec[j].v + beta * p.rec[j].t);
  }
  const int k_at = (int)(sdf_plane(s) - s.sv) + 6;
  g.add(k_at, c_f * dk.v + dk.t);
}

// closest_hit on a ray that hit at the marched t, the nearest primitive
// there `idx` (the record's winner): the cotangents of t, of the normal and
// of the raw material record (the plane's rgb is its checker albedo), whose
// stride A sets (MatAdj, or MediaMatAdj in the media instantiation).
template <class A>
__device__ __forceinline__ void sdf_closest_hit_adj(const SceneView& s, V3 ro, V3 rd, float t, int idx, float ct_t,
                                                    V3 ct_normal, const A& a, const GradSink& g, V3& c_ro,
                                                    V3& c_rd) {
  const V3 x = madd3(ro, rd, t);
  const int plane = s.n_materials - 1;
  scatter_material_adj(g, material_offset(s, idx, a), a, idx != plane);
  if (idx == plane) {
    const int albedo_at = (int)(sdf_plane(s) - s.sv) + 8;
    g.add(albedo_at + sdf_checker_pick(s, x), a.rgb.x + a.rgb.y + a.rgb.z);
  }
  if (ct_t == 0.0f && ct_normal.x == 0.0f && ct_normal.y == 0.0f && ct_normal.z == 0.0f) return;

  // normal = safe_normalize(grad): the cotangent of grad is the direction
  const V3 grad0 = sdf_gradient(s, x);
  const V3 c_grad = safe_normalize_adj(grad0, ct_normal);
  const int n = s.n_spheres + s.n_boxes + s.n_tori + 1;
  Dual w[SDF_MAX_PRIMS], kd[SDF_MAX_PRIMS];
  const DV3 xd = dv3(x, c_grad);
  const DV3 grad = sdf_union_forward(s, xd, n, w, kd);
  const V3 c_x = tangent(grad);  // H c_grad
  c_ro += c_x;
  c_rd += c_x * t;
  // Newton: t = t* - (f - sg(f)) / denom, the denominator detached
  const float denom = dot_rn(rd, safe_normalize(grad0));
  const float c_f = fabsf(denom) > NEWTON_GATE ? -(ct_t + dot(c_x, rd)) / denom : 0.0f;
  const V3 grad_f = value(grad);
  c_ro += grad_f * c_f;
  c_rd += grad_f * (c_f * t);
  sdf_union_reverse(s, xd, n, w, kd, c_f, g);
}

// The SDF backend with the hooks K2's two kernels call: the record kernel
// marches (sdf.cuh) and takes the nearest primitive at the hit as the
// winner; the adjoint marches nothing.
struct SdfAdj : Sdf {
  // sdf_closest_hit's march and hit test: t (+inf on a miss) and the
  // nearest primitive at the hit point.
  __device__ __forceinline__ static float closest_hit_rec(const SceneView& s, V3 ro, V3 rd, int& win) {
    const float t = sdf_march(s, ro, rd, SDF_T_MAX).t;
    win = 0;
    if (!sdf_converged(s, ro, rd, t)) return INFINITY;
    win = nearest_primitive(s, madd3(ro, rd, t));
    return t;
  }
  // sdf_closest_hit's normal and raw material at t, primitive `win`, in its
  // arithmetic.
  template <class M>
  __device__ __forceinline__ static void surface(const SceneView& s, V3 ro, V3 rd, float t, int win, V3& normal,
                                                 M& mat) {
    const V3 x = madd3(ro, rd, t);
    normal = sdf_normal(s, x);
    load_material(s, win, mat);
    if (win == s.n_materials - 1) mat.rgb = splat3(sdf_checker(s, x));
  }
  template <class A>
  __device__ __forceinline__ static void closest_hit_adj(const SceneView& s, V3 ro, V3 rd, float t, int win,
                                                         float ct_t, V3 ct_normal, const A& a, const GradSink& g,
                                                         V3& c_ro, V3& c_rd) {
    sdf_closest_hit_adj(s, ro, rd, t, win, ct_t, ct_normal, a, g, c_ro, c_rd);
  }
  __device__ __forceinline__ static void background_adj(const SceneView& s, V3 rd, V3 ct, const GradSink& g,
                                                        V3& c_rd) {
    sky_background_adj(s, (int)(sdf_plane(s) - s.sv) + 10, rd, ct, g, c_rd);
  }
};

}  // namespace pt
