// Scalar per-thread twin of models/bigmesh.py: the big triangle-mesh backend
// of the generic tracer (K8 inside K1 and K3).
//
// Replaces the TPU backend pathtracer_tpu/ops/megakernel_bigmesh.py
// (_closest_hit_bigmesh, _any_hit_bigmesh, _chunk_cull, _chunk_cols,
// _ray_rows_kernel, _background_bigmesh). The packed vector holds only the
// camera, the sky (7), the lights and the materials
// (ops/megakernel_bigmesh.pack_bigmesh_scene); the triangles come as the
// three tables of models/bigmesh.coef_tables beside it:
//
//   coef [n_chunks * 128, 16]  the Möller-Trumbore coefficients (mt_terms)
//   attr [8, n_chunks * 128]   unnormalised normal(3), material id, zeros
//   aabb [n_chunks, 8]         each chunk's min xyz, max xyz
//
// A thread walks the chunks in order. Each chunk first gets the JAX
// kernel's slab test against its box, with t_far the thread's best t so far
// (max_dist for the shadow ray): the TPU tests a tile's lanes together, a
// thread its own ray. The cull is exact for the same reason the tile's is:
// an equal t never replaces the winner under strict <. Inside an admitted
// chunk, mt_terms and mt_hit_t per triangle, unfused and in the plain
// version's order; the first minimum wins (argmin's lowest index). The
// winner's row of attr gives the normal (normalised, up (0, 1, 0) on a
// miss) and the material id by a direct read, where the TPU kernel gathers
// them with a one-hot product on its matrix unit.
//
// What bounds it on this card: the latency of each pair's dependent
// chain (its row's load, the determinant, the guard's branch) and the
// warp's divergence, not the operations (~46 a pair at most: 8 where the
// determinant's guard fails, 22 where u's does; tools/work.py counts them,
// and the pairs a warp runs for the union of its lanes' chunks, 1.5-2x the
// lanes' own) nor the table's bytes. A row (64 bytes, 16-byte aligned) is
// read as four float4, each only once the guard before it has passed: the
// three determinant coefficients (and k3) first, so a pair the guard
// rejects reads 16 bytes in one load; every lane of a warp reads the same
// row at once, a broadcast from the read-only cache, where the whole
// table stays (110.6 KB for the demo). The loop takes four rows at once so
// their loads overlap; their tests still run and win in order. Copying the
// tables to each block's shared memory was slower on the H100 (PERF.md
// §6): the copy per block and the blocks of fewer warps cost more than the
// loads it saves.
#pragma once

#include "tracer.cuh"

namespace pt {

constexpr int BIGMESH_CHUNK = 128;
constexpr int BIGMESH_FEAT = 16;
constexpr int BIGMESH_SKY = 12;  // sky horizon(3) zenith(3) scale, after the camera
constexpr int BIGMESH_LIGHTS = BIGMESH_SKY + 7;
constexpr float BIGMESH_EPS = 1e-7f;

// The big mesh scene's view with its tables (host side, for the launch).
inline SceneView bigmesh_view(const float* sv, int n_lights, int n_materials, const float* coef, const float* attr,
                              const float* aabb, int n_chunks) {
  SceneView s = {sv, n_lights, n_materials, false, BIGMESH_LIGHTS, 0, 0, 0};
  s.coef = coef;
  s.attr = attr;
  s.aabb = aabb;
  s.n_chunks = n_chunks;
  return s;
}

// A read of a table that no thread writes: through the read-only cache on
// the card.
__device__ __forceinline__ float table(const float* p) {
#ifdef __CUDA_ARCH__
  return __ldg(p);
#else
  return *p;
#endif
}

__device__ __forceinline__ float4 table4(const float4* p) {
#ifdef __CUDA_ARCH__
  return __ldg(p);
#else
  return *p;
#endif
}

// mt_terms and mt_hit_t of one (ray, triangle) pair from its coefficient
// row c (k0..k15 as four float4): t, or +inf where the pair is no hit.
// (Testing u's sign before the division was slower: a warp divides
// whenever one of its lanes passes, and about half of them do.)
__device__ __forceinline__ float mt_hit(const float4* c, V3 d, V3 m, V3 o) {
  const float4 a = table4(c);  // k0 k1 k2 k3
  const float det = -((mul_rn(a.x, d.x) + mul_rn(a.y, d.y)) + mul_rn(a.z, d.z));
  const float absdet = fabsf(det);
  if (!(absdet > BIGMESH_EPS)) return INFINITY;
  const float inv = 1.0f / det;
  const float4 b = table4(c + 1), e = table4(c + 2);  // k4..k7, k8..k11
  const float u_num = ((mul_rn(a.w, d.x) + mul_rn(b.x, d.y)) + mul_rn(b.y, d.z)) +
                      ((mul_rn(b.z, m.x) + mul_rn(b.w, m.y)) + mul_rn(e.x, m.z));
  const float u = u_num * inv;
  if (!(u >= 0.0f)) return INFINITY;
  const float4 f = table4(c + 3);  // k12..k15
  const float v_num = ((mul_rn(e.y, d.x) + mul_rn(e.z, d.y)) + mul_rn(e.w, d.z)) +
                      ((mul_rn(f.x, m.x) + mul_rn(f.y, m.y)) + mul_rn(f.z, m.z));
  const float v = v_num * inv;
  const float t = (((mul_rn(a.x, o.x) + mul_rn(a.y, o.y)) + mul_rn(a.z, o.z)) + f.w) * inv;
  return v >= 0.0f && u + v <= 1.0f && t > BIGMESH_EPS ? t : INFINITY;
}

// The slab test of _chunk_cull for one ray: can the ray meet the box inside
// (EPS, t_far)? invd is the ray's per-axis reciprocal direction.
__device__ __forceinline__ bool chunk_admits(const float* box, V3 o, V3 invd, float t_far) {
  float t_near = BIGMESH_EPS;
  const float oc[3] = {o.x, o.y, o.z}, ic[3] = {invd.x, invd.y, invd.z};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float t0 = (table(box + k) - oc[k]) * ic[k];
    const float t1 = (table(box + 3 + k) - oc[k]) * ic[k];
    t_near = fmaxf(t_near, fminf(t0, t1));
    t_far = fminf(t_far, fmaxf(t0, t1));
  }
  return t_near <= t_far;
}

__device__ __forceinline__ float safe_inv_dir(float d) { return 1.0f / (fabsf(d) > 1e-20f ? d : 1e-20f); }

// The chunk c's coefficient rows.
__device__ __forceinline__ const float4* chunk_rows(const SceneView& s, int c) {
  return reinterpret_cast<const float4*>(s.coef) + (size_t)c * BIGMESH_CHUNK * (BIGMESH_FEAT / 4);
}

// The closest hit's walk over the chunks: the nearest t (+inf on a miss)
// and its triangle `win` (-1 on a miss), the first minimum under strict <.
__device__ __forceinline__ float bigmesh_walk(const SceneView& s, V3 ro, V3 rd, int& win) {
  const V3 m = cross_rn(ro, rd);
  const V3 invd = v3(safe_inv_dir(rd.x), safe_inv_dir(rd.y), safe_inv_dir(rd.z));
  float best = INFINITY;
  win = -1;
  for (int c = 0; c < s.n_chunks; ++c) {
    if (!chunk_admits(s.aabb + 8 * c, ro, invd, best)) continue;
    const float4* rows = chunk_rows(s, c);
#pragma unroll 4
    for (int j = 0; j < BIGMESH_CHUNK; ++j) {
      const float t = mt_hit(rows + j * (BIGMESH_FEAT / 4), rd, m, ro);
      if (t < best) {
        best = t;
        win = c * BIGMESH_CHUNK + j;
      }
    }
  }
  return best;
}

// The big mesh backend of the generic tracer.
struct BigMesh {
  template <class M = Material>
  __device__ __forceinline__ static float closest_hit(const SceneView& s, V3 ro, V3 rd, V3& normal, M& mat) {
    int win;
    const float best = bigmesh_walk(s, ro, rd, win);
    const int tpad = s.n_chunks * BIGMESH_CHUNK;
    const V3 n = win < 0 ? v3(0.0f, 1.0f, 0.0f)
                         : safe_normalize_rn(v3(table(s.attr + win), table(s.attr + tpad + win),
                                                table(s.attr + 2 * tpad + win)));
    normal = dot_rn(n, rd) > 0.0f ? -n : n;
    if (win < 0) {
      mat = default_material();
      return INFINITY;
    }
    load_material(s, (int)table(s.attr + 3 * tpad + win), mat);
    return best;
  }

  // Occlusion closer than max_dist (the fixed semantics); the first
  // occluding triangle ends the walk.
  __device__ __forceinline__ static bool any_hit(const SceneView& s, V3 ro, V3 rd, float max_dist) {
    const V3 m = cross_rn(ro, rd);
    const V3 invd = v3(safe_inv_dir(rd.x), safe_inv_dir(rd.y), safe_inv_dir(rd.z));
    for (int c = 0; c < s.n_chunks; ++c) {
      if (!chunk_admits(s.aabb + 8 * c, ro, invd, max_dist)) continue;
      const float4* rows = chunk_rows(s, c);
#pragma unroll 4
      for (int j = 0; j < BIGMESH_CHUNK; ++j) {
        if (mt_hit(rows + j * (BIGMESH_FEAT / 4), rd, m, ro) < max_dist) return true;
      }
    }
    return false;
  }

  __device__ __forceinline__ static V3 background(const SceneView& s, V3 rd) {
    return sky_background(s.sv + BIGMESH_SKY, rd);
  }
};

}  // namespace pt
