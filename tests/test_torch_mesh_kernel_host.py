"""The mesh backends of the CUDA megakernel, compiled for the host and held
to their plain PyTorch versions.

`csrc/mesh.cuh` (K7) and `csrc/bigmesh.cuh` (K8) are plain C++ behind the
shim of tests/test_torch_kernel_host.py, so g++ builds them with
-ffp-contract=off and a host loop runs `trace_sample` with each backend for
every pixel as K1's threads do, on the packed vector, the topology and the
tables that ops/megakernel hands the kernel. Each frame is held per pixel
to the plain version (the eager integrator on models/mesh, models/bigmesh)
within chip_smoke.py's image gate. The small mesh's triangle table, which
each block of the kernels stages, is held bit for bit to the values its
tests computed inline before it, and its triangle test to the test over
the vertices, rays through the mesh's shared edges among them. The card
run checks what nvcc makes of it.
"""

import ctypes

import numpy as np
import pytest
import torch

from pathtracer_tpu_torch.integrator.tracer import FIXED, VERBATIM
from pathtracer_tpu_torch.models import bigmesh, mesh
from pathtracer_tpu_torch.models import light as L
from pathtracer_tpu_torch.ops import megakernel as MK
from pathtracer_tpu_torch.ops import rng
from pathtracer_tpu_torch.ops.vecmath import V3, safe_normalize
from test_torch_kernel_host import (  # noqa: F401
    MESH_VIEW, PRELUDE, build_shim, launch_keys, mesh_glass, one_torch_thread,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SHIM = PRELUDE + r"""
#include "bigmesh.cuh"
#include "mesh.cuh"
#include "tracer.cuh"
""" + MESH_VIEW + r"""

template <class B>
static void frame(const pt::SceneView& s, const uint32_t* keys, float* out, int width, int height, int spp,
                  int depth, int flags) {
  const int n = width * height;
  for (int p = 0; p < n; ++p) {
    pt::V3 sum = pt::splat3(0.0f);
    for (int k = 0; k < spp; ++k) {
      const uint32_t* kk = keys + 4 * k;
      pt::V3 r = pt::trace_sample<B>(s, p, n, width, height, depth, flags, kk[0], kk[1], kk[2], kk[3]);
      sum = k == 0 ? r : sum + r;
    }
    if (spp > 1) sum = sum / (float)spp;
    out[4 * p + 0] = sum.x;
    out[4 * p + 1] = sum.y;
    out[4 * p + 2] = sum.z;
    out[4 * p + 3] = 1.0f;
  }
}

extern "C" void host_render_mesh(const float* sv, const uint32_t* keys, float* out, int width, int height, int spp,
                                 int depth, int n_lights, int n_materials, int flags, const int* topo, int n_tris,
                                 int n_verts) {
  frame<pt::Mesh>(host_mesh_view(sv, n_lights, n_materials, topo, n_tris, n_verts), keys, out, width, height, spp,
                  depth, flags);
}

extern "C" void host_render_bigmesh(const float* sv, const uint32_t* keys, float* out, int width, int height,
                                    int spp, int depth, int n_lights, int n_materials, int flags, const float* coef,
                                    const float* attr, const float* aabb, int n_chunks) {
  frame<pt::BigMesh>(pt::bigmesh_view(sv, n_lights, n_materials, coef, attr, aabb, n_chunks), keys, out, width,
                     height, spp, depth, flags);
}

// The small mesh's triangle tests before its table: each triangle's three
// vertices read by index and its edges formed in the test (the reference
// of host_mesh_table and host_mesh_tests).
static pt::V3 old_vertex(const float* sv, int v) { return pt::load3(sv + pt::MESH_VERTS + 3 * v); }

static float old_ray_triangle(pt::V3 ro, pt::V3 rd, pt::V3 v0, pt::V3 v1, pt::V3 v2) {
  const float eps = 1e-7f;
  const pt::V3 e1 = v1 - v0, e2 = v2 - v0;
  const pt::V3 p = pt::cross_rn(rd, e2);
  const float det = pt::dot_rn(e1, p);
  const bool ok_det = std::fabs(det) > eps;
  const float inv_det = ok_det ? 1.0f / det : 0.0f;
  const pt::V3 s = ro - v0;
  const float u = pt::dot_rn(s, p) * inv_det;
  const pt::V3 q = pt::cross_rn(s, e1);
  const float v = pt::dot_rn(rd, q) * inv_det;
  const float t = pt::dot_rn(e2, q) * inv_det;
  return ok_det && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > eps ? t : INFINITY;
}

// Triangle i's staged rows (staged[16 i ...], as mesh.cuh's stage_mesh_triangle
// lays them out) and the values the tests computed inline before the table
// (inline_[16 i ...]: a, b - a, c - a, the normal
// safe_normalize_rn(cross_rn(b - a, c - a)), the indices as floats).
extern "C" void host_mesh_table(const float* sv, const int* topo, int n_tris, int n_verts, float* staged,
                                float* inline_) {
  const pt::SceneView s = host_mesh_view(sv, 0, 0, topo, n_tris, n_verts);
  for (int i = 0; i < n_tris; ++i) {
    for (int r = 0; r < pt::MESH_ROWS; ++r) {
      const float4 row = s.tris[pt::MESH_ROWS * i + r];
      const float v[4] = {row.x, row.y, row.z, row.w};
      for (int c = 0; c < 4; ++c) staged[16 * i + 4 * r + c] = v[c];
    }
    const int* tri = topo + 4 * i;
    const pt::V3 a = old_vertex(sv, tri[0]);
    const pt::V3 rows[4] = {a, old_vertex(sv, tri[1]) - a, old_vertex(sv, tri[2]) - a,
                            pt::safe_normalize_rn(pt::cross_rn(old_vertex(sv, tri[1]) - a, old_vertex(sv, tri[2]) - a))};
    const int w[4] = {tri[3], tri[0], tri[1], tri[2]};
    for (int r = 0; r < 4; ++r) {
      const float v[4] = {rows[r].x, rows[r].y, rows[r].z, (float)w[r]};
      for (int c = 0; c < 4; ++c) inline_[16 * i + 4 * r + c] = v[c];
    }
  }
}

// Ray j against every triangle i: t over the staged table (mesh_triangle,
// t_table[j * n_tris + i]) and over the vertices (t_vertices); then the
// closest hit's t and the shadow ray's verdict at max_dist[j] as Mesh runs
// them (closest[j], occluded[j]).
extern "C" void host_mesh_tests(const float* sv, const int* topo, int n_tris, int n_verts, int n, const float* ro,
                                const float* rd, const float* max_dist, float* t_table, float* t_vertices,
                                float* closest, uint8_t* occluded) {
  const pt::SceneView s = host_mesh_view(sv, 0, 0, topo, n_tris, n_verts);
  for (int j = 0; j < n; ++j) {
    const pt::V3 o = pt::v3(ro[3 * j], ro[3 * j + 1], ro[3 * j + 2]);
    const pt::V3 d = pt::v3(rd[3 * j], rd[3 * j + 1], rd[3 * j + 2]);
    for (int i = 0; i < n_tris; ++i) {
      const int* tri = topo + 4 * i;
      t_table[(size_t)j * n_tris + i] = pt::mesh_triangle(s, i, o, d);
      t_vertices[(size_t)j * n_tris + i] =
          old_ray_triangle(o, d, old_vertex(sv, tri[0]), old_vertex(sv, tri[1]), old_vertex(sv, tri[2]));
    }
    pt::V3 normal;
    pt::Material mat;
    closest[j] = pt::Mesh::closest_hit(s, o, d, normal, mat);
    occluded[j] = pt::Mesh::any_hit(s, o, d, max_dist[j]);
  }
}

// K8's walk before its rows were read as float4 (all 16 coefficients read
// one by one, then the guards), the reference of host_walks.
static float old_mt_hit(const float* c, pt::V3 d, pt::V3 m, pt::V3 o) {
  float k[16];
  for (int i = 0; i < 16; ++i) k[i] = c[i];
  const float det = -((pt::mul_rn(k[0], d.x) + pt::mul_rn(k[1], d.y)) + pt::mul_rn(k[2], d.z));
  if (!(std::fabs(det) > pt::BIGMESH_EPS)) return INFINITY;
  const float inv = 1.0f / det;
  const float u_num = ((pt::mul_rn(k[3], d.x) + pt::mul_rn(k[4], d.y)) + pt::mul_rn(k[5], d.z)) +
                      ((pt::mul_rn(k[6], m.x) + pt::mul_rn(k[7], m.y)) + pt::mul_rn(k[8], m.z));
  const float u = u_num * inv;
  if (!(u >= 0.0f)) return INFINITY;
  const float v_num = ((pt::mul_rn(k[9], d.x) + pt::mul_rn(k[10], d.y)) + pt::mul_rn(k[11], d.z)) +
                      ((pt::mul_rn(k[12], m.x) + pt::mul_rn(k[13], m.y)) + pt::mul_rn(k[14], m.z));
  const float v = v_num * inv;
  const float t = (((pt::mul_rn(k[0], o.x) + pt::mul_rn(k[1], o.y)) + pt::mul_rn(k[2], o.z)) + k[15]) * inv;
  return v >= 0.0f && u + v <= 1.0f && t > pt::BIGMESH_EPS ? t : INFINITY;
}

// Pair i: mt_hit of row i (16 floats, 16-byte aligned) against ray i (d,
// m, o: 9 floats), K8's (t_new, its row read as float4 as its guards pass)
// and the old walk's (t_old).
extern "C" void host_mt_hit(const float* rows, const float* rays, int n, float* t_new, float* t_old) {
  for (int i = 0; i < n; ++i) {
    const float* r = rays + 9 * i;
    const pt::V3 d = pt::v3(r[0], r[1], r[2]), m = pt::v3(r[3], r[4], r[5]), o = pt::v3(r[6], r[7], r[8]);
    t_new[i] = pt::mt_hit(reinterpret_cast<const float4*>(rows + 16 * (size_t)i), d, m, o);
    t_old[i] = old_mt_hit(rows + 16 * (size_t)i, d, m, o);
  }
}

// Ray i: the closest hit's (t, winner) of the old walk (t_out[2i],
// win_out[2i]) and of K8's walk as the kernel runs it (t_out[2i + 1],
// win_out[2i + 1]), and the shadow ray's verdict at max_dist[i] of each
// (occluded[2i + 0..1]).
extern "C" void host_walks(const float* coef, const float* aabb, int n_chunks, int n, const float* ro, const float* rd,
                           const float* max_dist, float* t_out, int* win_out, uint8_t* occluded) {
  pt::SceneView s = pt::bigmesh_view(nullptr, 0, 0, coef, nullptr, aabb, n_chunks);
  for (int i = 0; i < n; ++i) {
    const pt::V3 o = pt::v3(ro[3 * i], ro[3 * i + 1], ro[3 * i + 2]);
    const pt::V3 d = pt::v3(rd[3 * i], rd[3 * i + 1], rd[3 * i + 2]);
    const pt::V3 m = pt::cross_rn(o, d);
    const pt::V3 invd = pt::v3(pt::safe_inv_dir(d.x), pt::safe_inv_dir(d.y), pt::safe_inv_dir(d.z));
    float best = INFINITY;
    int win = -1;
    bool occ = false;
    for (int c = 0; c < n_chunks; ++c) {
      const bool closest = pt::chunk_admits(aabb + 8 * c, o, invd, best);
      const bool shadow = pt::chunk_admits(aabb + 8 * c, o, invd, max_dist[i]);
      for (int j = 0; j < pt::BIGMESH_CHUNK && (closest || shadow); ++j) {
        const float t = old_mt_hit(coef + (size_t)(c * pt::BIGMESH_CHUNK + j) * 16, d, m, o);
        if (closest && t < best) {
          best = t;
          win = c * pt::BIGMESH_CHUNK + j;
        }
        occ = occ || (shadow && t < max_dist[i]);
      }
    }
    t_out[2 * i] = best;
    win_out[2 * i] = win;
    occluded[2 * i] = occ;
    t_out[2 * i + 1] = pt::bigmesh_walk(s, o, d, win_out[2 * i + 1]);
    occluded[2 * i + 1] = pt::BigMesh::any_hit(s, o, d, max_dist[i]);
  }
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    lib = build_shim(tmp_path_factory.mktemp("mesh_kernel_host"), SHIM)
    p, i = ctypes.c_void_p, ctypes.c_int
    head = [p, p, p, i, i, i, i, i, i, i]
    lib.host_render_mesh.argtypes = head + [p, i, i]
    lib.host_render_bigmesh.argtypes = head + [p, p, p, i]
    lib.host_walks.argtypes = [p, p, i, i, p, p, p, p, p, p]
    lib.host_mt_hit.argtypes = [p, p, i, p, p]
    lib.host_mesh_table.argtypes = [p, p, i, i, p, p]
    lib.host_mesh_tests.argtypes = [p, p, i, i, i, p, p, p, p, p, p, p]
    return lib


def host_render(lib, scene, key, w, h, spp, quirks):
    """What render_frame_megakernel hands K1, run on the host."""
    family = "mesh" if scene.closest_hit_fn is mesh.closest_hit else "bigmesh"
    b = MK.BACKENDS[family]
    # held: the library reads their memory
    sv, keys, extras = b.pack(scene, w, h).contiguous(), launch_keys(key, spp), b.extras(scene)
    out = torch.empty((h, w, 4), dtype=torch.float32)
    entry = lib.host_render_mesh if family == "mesh" else lib.host_render_bigmesh
    entry(sv.data_ptr(), keys.data_ptr(), out.data_ptr(), w, h, spp, scene.recursion_depth, scene.num_lights,
          int(scene.params.materials.roughness.shape[0]), MK.kernel_flags(scene, quirks),
          *(t.data_ptr() for t in extras), *b.counts(scene))
    return out


def _moved_vertex_mesh():
    """The mesh demo with the pyramid's apex moved and a rectangular light
    beside the spherical one."""
    p = mesh.default_params()
    v = p.vertices
    x, y = v.x.clone(), v.y.clone()
    x[16], y[16] = 1.1, 1.2
    lights = L.concat_lights(
        L.spherical_light((3.0, 2.0, 2.0), 1.0, (3.0, 3.0, 3.0)),
        L.rect_light((-2.0, 3.0, -1.0), (1.0, 0.0, 0.0), (0.0, 0.0, 1.0), (2.0, 2.0, 2.0)),
    )
    return mesh.make_scene(params=p._replace(vertices=V3(x, y, v.z)), lights=lights)


CASES = {
    "mesh_verbatim": (lambda: mesh.make_scene(), 1, VERBATIM),
    "mesh_spp2": (lambda: mesh.make_scene(), 2, VERBATIM),
    "mesh_fixed": (lambda: mesh.make_scene(), 1, FIXED),
    "mesh_moved_vertex_two_lights": (_moved_vertex_mesh, 1, FIXED),
    "bigmesh_verbatim": (lambda: bigmesh.make_scene(), 1, VERBATIM),
    "bigmesh_spp2": (lambda: bigmesh.make_scene(), 2, VERBATIM),
    "bigmesh_fixed": (lambda: bigmesh.make_scene(), 1, FIXED),
    "bigmesh_ground_grid": (lambda: bigmesh.make_scene(params=bigmesh.default_params(ground_grid=4)), 1, VERBATIM),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_mesh_kernel_code_matches_plain_version(host_lib, case):
    """32x24, depth 4, per pixel within the image gate."""
    make, spp, quirks = CASES[case]
    scene = make()
    key = rng.prng_key(sorted(CASES).index(case) + 31)
    img = host_render(host_lib, scene, key, 32, 24, spp, quirks).numpy()
    ref = MK.render_frame_reference(scene, key, 32, 24, spp, quirks).numpy()
    assert np.isfinite(img).all()
    diff = np.abs(img.astype(np.float64) - ref)
    assert np.quantile(diff, 0.999) < 1e-4
    assert diff.mean() < 1e-5


@pytest.mark.parametrize("ground_grid", [0, 4], ids=["demo", "ground_grid"])
def test_bigmesh_walk_matches_old_walk(host_lib, ground_grid):
    """K8's walk over float4 rows gives the scalar walk's winner and t on
    every ray, bit for bit, and its shadow verdict: camera-like rays toward the mesh, rays from inside its box,
    grazing rays along the ground, with max_dist short of and past the
    hit."""
    scene = bigmesh.make_scene(params=bigmesh.default_params(ground_grid=ground_grid))
    coef, _, aabb = (t.contiguous() for t in bigmesh.coef_tables(scene.params.unpack()))
    rs = np.random.default_rng(41 + ground_grid)
    n = 6000
    ro = np.concatenate([rs.uniform([-4, -0.5, 3], [4, 3, 6], (n // 3, 3)),
                         rs.uniform([-1.5, -1.0, -1.5], [1.5, 1.5, 1.5], (n // 3, 3)),
                         np.stack([rs.uniform(-3, 3, n // 3), np.full(n // 3, -0.999), rs.uniform(-3, 3, n // 3)], 1)])
    target = np.concatenate([rs.uniform([-1.5, -1.0, -1.5], [1.5, 1.5, 1.5], (2 * (n // 3), 3)),
                             ro[2 * (n // 3):] + np.stack([rs.uniform(-1, 1, n // 3), rs.uniform(-1e-3, 1e-3, n // 3),
                                                           rs.uniform(-1, 1, n // 3)], 1)])
    rd = target - ro
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    max_dist = rs.uniform(0.0, 8.0, n)
    ro, rd, max_dist = (torch.from_numpy(np.ascontiguousarray(a, np.float32)) for a in (ro, rd, max_dist))
    t, win, occ = torch.empty((n, 2)), torch.empty((n, 2), dtype=torch.int32), torch.empty((n, 2), dtype=torch.uint8)
    host_lib.host_walks(coef.data_ptr(), aabb.data_ptr(), aabb.shape[0], n, ro.data_ptr(), rd.data_ptr(),
                        max_dist.data_ptr(), t.data_ptr(), win.data_ptr(), occ.data_ptr())
    assert torch.equal(t[:, 1].view(torch.int32), t[:, 0].view(torch.int32))
    assert torch.equal(win[:, 1], win[:, 0])
    assert torch.equal(occ[:, 1], occ[:, 0])
    hits = win[:, 0] >= 0
    assert 0.2 < float(hits.double().mean()) < 0.95
    assert 0.05 < float(occ[:, 0].double().mean()) < 0.95


def test_mt_hit_matches_old_walk_at_every_magnitude():
    """K8's mt_hit (a row read as four float4, each once the guard before
    it passed) on synthetic rows and rays of every magnitude (tiny and
    subnormal u numerators, determinants up to 1e30, both signs): its t is
    the old walk's bit for bit, products that round to zero included."""
    import tempfile
    from pathlib import Path

    lib = build_shim(Path(tempfile.mkdtemp()), SHIM)
    lib.host_mt_hit.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    rs = np.random.default_rng(43)
    n = 60_000
    mag = lambda size, lo, hi: np.sign(rs.standard_normal(size)) * 10.0 ** rs.uniform(lo, hi, size)
    rows = np.concatenate([rs.uniform(-2, 2, (n // 3, 16)), mag((n // 3, 16), -40, 30),
                           np.concatenate([mag((n // 3, 3), 6, 30), mag((n // 3, 13), -44, -20)], axis=1)])
    rays = np.concatenate([rs.uniform(-2, 2, (n // 3, 9)), mag((n // 3, 9), -20, 10),
                           np.concatenate([rs.uniform(-1, 1, (n // 3, 3)), mag((n // 3, 6), -44, -30)], axis=1)])
    rows, rays = (torch.from_numpy(a.astype(np.float32)).contiguous() for a in (rows, rays))
    t_new, t_old = torch.empty(n), torch.empty(n)
    lib.host_mt_hit(rows.data_ptr(), rays.data_ptr(), n, t_new.data_ptr(), t_old.data_ptr())
    assert torch.equal(t_new.view(torch.int32), t_old.view(torch.int32))
    assert int(torch.isfinite(t_old).sum()) > 300  # hits, beside the pairs each guard rejects
    k, d, m = rows.double(), rays[:, :3].double(), rays[:, 3:6].double()
    det = -(k[:, :3] * d).sum(1)
    u_num = (k[:, 3:6] * d).sum(1) + (k[:, 6:9] * m).sum(1)
    tiny = (det.abs() > 1e-7) & (torch.sign(u_num) * torch.sign(det) < 0) & ((u_num / det).abs() < 1e-40)
    assert int(tiny.sum()) > 100


def _mesh_inputs(scene):
    """(packed vector, topology, n_tris, n_verts) as K1 gets them, held."""
    b = MK.BACKENDS["mesh"]
    sv = b.pack(scene, 64, 48, MK.scene_media(scene)).contiguous()
    return (sv, *b.extras(scene), *b.counts(scene))


@pytest.mark.parametrize("make", [mesh.make_scene, mesh_glass], ids=["demo", "media_glass"])
def test_staged_table_is_the_inline_values(host_lib, make):
    """The triangle table each block stages (mesh.cuh stage_mesh_triangle)
    holds, bit for bit, the first vertex, the edges and the normal that the
    triangle tests and the winner computed inline before it, with the
    topology's indices, and the plain version's float32 corners, edges and
    normal (models/mesh). Under 1 s."""
    scene = make()
    sv, topo, n_tris, n_verts = _mesh_inputs(scene)
    staged, inline = torch.empty((n_tris, 4, 4)), torch.empty((n_tris, 4, 4))
    host_lib.host_mesh_table(sv.data_ptr(), topo.data_ptr(), n_tris, n_verts, staged.data_ptr(), inline.data_ptr())
    assert torch.equal(staged.view(torch.int32), inline.view(torch.int32))
    assert torch.equal(staged[:, :, 3].to(torch.int32), topo[:, [3, 0, 1, 2]])
    p = scene.params.unpack()
    a, b, c = mesh.corners(p)
    n = safe_normalize((b - a).cross(c - a))
    plain = torch.stack([torch.stack([v.x, v.y, v.z], 1) for v in (a, b - a, c - a, n)], 1)
    assert torch.equal(staged[:, :, :3].view(torch.int32), plain.view(torch.int32))


def test_table_triangle_test_is_the_vertex_test(host_lib):
    """Möller-Trumbore over the staged table (ray_triangle_edges) gives,
    for every ray and triangle of the demo mesh, the t of the test over
    the three vertices bit for bit, and so do the closest hit and the
    shadow ray: camera-like rays toward the mesh, and rays aimed at points
    of the edges that two triangles share (where the two tests' u and v
    decide the winner), some of them exactly at a vertex. Under 1 s."""
    scene = mesh.make_scene()
    sv, topo, n_tris, n_verts = _mesh_inputs(scene)
    p = scene.params.unpack()
    verts = torch.stack([p.vertices.x, p.vertices.y, p.vertices.z], 1).double().numpy()
    tris = topo[:, :3].numpy()
    edges = {}
    for i, tri in enumerate(tris):
        for a, b in ((tri[0], tri[1]), (tri[1], tri[2]), (tri[2], tri[0])):
            edges.setdefault((min(a, b), max(a, b)), []).append(i)
    shared = np.array([e for e, owners in edges.items() if len(owners) > 1])
    assert len(shared) >= 10
    rs = np.random.default_rng(7)
    n = 6000
    pick = shared[rs.integers(len(shared), size=n // 2)]
    s = rs.uniform(0.0, 1.0, (n // 2, 1))
    s[: n // 20] = rs.integers(0, 2, (n // 20, 1))  # at a vertex
    on_edge = verts[pick[:, 0]] * (1 - s) + verts[pick[:, 1]] * s
    ro = rs.uniform([-4, -1, 2], [4, 4, 7], (n, 3))
    target = np.concatenate([on_edge, rs.uniform([-1.5, -1.0, -1.5], [1.5, 1.5, 1.5], (n - n // 2, 3))])
    rd = target - ro
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    max_dist = rs.uniform(0.0, 8.0, n)
    ro, rd, max_dist = (torch.from_numpy(np.ascontiguousarray(a, np.float32)) for a in (ro, rd, max_dist))
    t_table, t_vertices = torch.empty((n, n_tris)), torch.empty((n, n_tris))
    closest, occluded = torch.empty(n), torch.empty(n, dtype=torch.uint8)
    host_lib.host_mesh_tests(sv.data_ptr(), topo.data_ptr(), n_tris, n_verts, n, ro.data_ptr(), rd.data_ptr(),
                             max_dist.data_ptr(), t_table.data_ptr(), t_vertices.data_ptr(), closest.data_ptr(),
                             occluded.data_ptr())
    assert torch.equal(t_table.view(torch.int32), t_vertices.view(torch.int32))
    assert torch.equal(closest.view(torch.int32), t_vertices.min(1).values.view(torch.int32))
    assert torch.equal(occluded.bool(), (t_vertices < max_dist[:, None]).any(1))
    hits = torch.isfinite(t_vertices[: n // 2]).sum(1)
    assert float((hits >= 2).double().mean()) > 0.2  # rays through a shared edge that both triangles take
    assert 0.2 < float(torch.isfinite(closest).double().mean()) < 0.95
