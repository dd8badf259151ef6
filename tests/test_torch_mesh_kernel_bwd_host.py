"""The small mesh backend's adjoint (K7 inside K2, `csrc/mesh_adj.cuh`),
compiled for the host and held to torch autograd of its plain version.

As in tests/test_torch_sdf_kernel_bwd_host.py, g++ builds the per-thread
headers behind the shim's qualifiers (-ffp-contract=off, like the plain
version's separate tensor ops) and a host loop runs K2's record step and
then its adjoint step with `MeshAdj` for every pixel and sample as K2's two
kernels' threads do (HOST_BACKWARD), on the packed vector and the topology
that ops/megakernel hands the kernel; the records' carries (and so the
recorded winners: K1's first minimum, strict `<`) are held bit for bit to
what tracer.cuh's bounce with Mesh hands on, and the summed
d(<ct, frame>)/d(sv) to
`ops/megakernel.render_grad_reference` (autograd of the eager frame of the
scene `megakernel_mesh.unpack_mesh_scene` reads from the same vector) with
`assert_grad_close` (entries above 1e-3 max|ref| within rtol 5e-3, the
others within 1e-3 max|ref|).

The pieces are held lane by lane (to 1e-3 of the lane's largest entry)
against autograd of `ops/intersect.ray_triangle` and `models/mesh`:
Möller-Trumbore's t at seeded triangles and rays and at determinants just
past the guard, and the whole closest hit (t, the face-forward normal and
the material) at seeded rays through the demo mesh. Crafted cases: a ray
through an edge two triangles share at one exact t, where the first
triangle takes the whole cotangent (K1's and JAX's strict `<`; an even
split, as jnp.min gives, fails); and frames where every camera ray misses
the mesh and sees the light, or sees the light in front of the mesh, in
which the vertices get exactly no gradient, as in JAX.
"""

import ctypes

import numpy as np
import pytest
import torch

from pathtracer_tpu_torch.integrator.tracer import FIXED, VERBATIM
from pathtracer_tpu_torch.models import analytical, mesh
from pathtracer_tpu_torch.models import light as L
from pathtracer_tpu_torch.models.camera import Pinhole
from pathtracer_tpu_torch.ops import megakernel as MK
from pathtracer_tpu_torch.ops import megakernel_mesh as MM
from pathtracer_tpu_torch.ops import rng
from pathtracer_tpu_torch.ops.intersect import ray_triangle
from pathtracer_tpu_torch.ops.vecmath import V3, v3
from test_torch_kernel_bwd_host import HOST_BACKWARD, assert_carries_equal, assert_grad_close, record_carries
from test_torch_kernel_host import PRELUDE, build_shim, launch_keys, one_torch_thread  # noqa: F401
from test_torch_sdf_kernel_bwd_host import assert_lanes_close, f32

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SHIM = PRELUDE + r"""
#include "mesh_adj.cuh"
#include "tracer_adj.cuh"
""" + HOST_BACKWARD + r"""

static pt::V3 at3(const float* a, int i) { return pt::v3(a[3 * i], a[3 * i + 1], a[3 * i + 2]); }
static void put3(float* a, int i, pt::V3 v) { a[3 * i] = v.x; a[3 * i + 1] = v.y; a[3 * i + 2] = v.z; }

extern "C" void host_grad_mesh(const float* sv, const int* topo, int n_tris, int n_verts, const uint32_t* keys,
                               const float* ct, float* grad, int width, int height, int spp, int depth, int n_lights,
                               int n_materials, int flags) {
  host_backward<pt::MeshAdj, false>(pt::mesh_view(sv, n_lights, n_materials, topo, n_tris, n_verts), keys, ct, grad,
                                    width, height, spp, depth, flags);
}

extern "C" void host_carries_mesh(const float* sv, const int* topo, int n_tris, int n_verts, const uint32_t* keys,
                                  int width, int height, int spp, int depth, int n_lights, int n_materials, int flags,
                                  float* rec_carry, float* ref_carry, int* rec_len, int* ref_len) {
  host_carries<pt::MeshAdj, false>(pt::mesh_view(sv, n_lights, n_materials, topo, n_tris, n_verts), keys, width,
                                   height, spp, depth, flags, rec_carry, ref_carry, rec_len, ref_len);
}

// Ray i against triangle i: t[i], and for ct_t = 1 on a hit the cotangents
// of ro, rd, v0, v1, v2 into out[15 i ...] (zero on a miss).
extern "C" void host_ray_triangle_adj(int n, const float* ro, const float* rd, const float* v0, const float* v1,
                                      const float* v2, float* t, float* out) {
  for (int i = 0; i < n; ++i) {
    pt::V3 c[5] = {pt::splat3(0.0f), pt::splat3(0.0f), pt::splat3(0.0f), pt::splat3(0.0f), pt::splat3(0.0f)};
    t[i] = pt::ray_triangle(at3(ro, i), at3(rd, i), at3(v0, i), at3(v1, i), at3(v2, i));
    if (std::isfinite(t[i])) {
      pt::ray_triangle_adj(at3(ro, i), at3(rd, i), at3(v0, i), at3(v1, i), at3(v2, i), 1.0f, c[0], c[1], c[2], c[3],
                           c[4]);
    }
    for (int j = 0; j < 5; ++j) put3(out + 15 * i, j, c[j]);
  }
}

// Ray i: the record step's winner; on a hit, the closest hit's adjoint for
// the cotangents of t, the normal and the material's rgb: c_ro, c_rd and
// the row grad[n_sv i]. hit[i] says whether the ray hit.
extern "C" void host_closest_hit_adj(const float* sv, const int* topo, int n_tris, int n_verts, int n_lights,
                                     int n_materials, int n_sv, int n, const float* ro, const float* rd,
                                     const float* ct_t, const float* ct_n, const float* ct_rgb, float* c_ro,
                                     float* c_rd, float* grad, uint8_t* hit) {
  const pt::SceneView s = pt::mesh_view(sv, n_lights, n_materials, topo, n_tris, n_verts);
  for (int i = 0; i < n; ++i) {
    const pt::V3 o = at3(ro, i), d = at3(rd, i);
    int win;
    const float t = pt::MeshAdj::closest_hit_rec(s, o, d, win);
    hit[i] = std::isfinite(t);
    pt::V3 co = pt::splat3(0.0f), cd = pt::splat3(0.0f);
    if (hit[i]) {
      pt::MatAdj a = pt::zero_mat_adj();
      a.rgb = at3(ct_rgb, i);
      pt::MeshAdj::closest_hit_adj(s, o, d, t, win, ct_t[i], at3(ct_n, i), a, {grad + (size_t)n_sv * i, 1}, co, cd);
    }
    put3(c_ro, i, co);
    put3(c_rd, i, cd);
  }
}

// Direction i: the sky's adjoint for the cotangent ct[3i]: c_rd and the row.
extern "C" void host_sky_adj(const float* sv, const int* topo, int n_tris, int n_verts, int n_lights,
                             int n_materials, int n_sv, int n, const float* rd, const float* ct, float* c_rd,
                             float* grad) {
  const pt::SceneView s = pt::mesh_view(sv, n_lights, n_materials, topo, n_tris, n_verts);
  for (int i = 0; i < n; ++i) {
    pt::V3 cd = pt::splat3(0.0f);
    pt::MeshAdj::background_adj(s, at3(rd, i), at3(ct, i), {grad + (size_t)n_sv * i, 1}, cd);
    put3(c_rd, i, cd);
  }
}
"""


class HostMeshAdj:
    """The shim's entry points, fed what K2's wrapper hands the kernel."""

    def __init__(self, lib):
        self.lib = lib

    @staticmethod
    def _scene(scene, w=8, h=8):
        # Held in variables until the call returns: ctypes gets raw pointers.
        sv = MM.pack_mesh_scene(scene, w, h).contiguous()
        (topo,) = MM.mesh_topology(scene)
        n_tris, n_verts = MM.mesh_counts(scene)
        return sv, topo, n_tris, n_verts, scene.num_lights, int(scene.params.materials.roughness.shape[0])

    def grad(self, scene, key, ct, w, h, spp, quirks):
        sv, topo, n_tris, n_verts, n_lights, n_mat = self._scene(scene, w, h)
        keys, ct = launch_keys(key, spp), ct.contiguous()
        grad = torch.zeros(sv.shape[1], dtype=torch.float32)
        self.lib.host_grad_mesh(sv.data_ptr(), topo.data_ptr(), n_tris, n_verts, keys.data_ptr(), ct.data_ptr(),
                                grad.data_ptr(), w, h, spp, scene.recursion_depth, n_lights, n_mat,
                                MK.kernel_flags(scene, quirks))
        return sv, grad[None]

    def carries(self, scene, key, w, h, spp, quirks):
        """record_carries of the shim's host_carries_mesh."""
        sv, topo, n_tris, n_verts, n_lights, n_mat = self._scene(scene, w, h)
        keys = launch_keys(key, spp)
        head = (sv.data_ptr(), topo.data_ptr(), n_tris, n_verts, keys.data_ptr(), w, h, spp, scene.recursion_depth,
                n_lights, n_mat, MK.kernel_flags(scene, quirks))
        return record_carries(self.lib.host_carries_mesh, head, w, h, spp, scene.recursion_depth, 14)

    def ray_triangle_adj(self, ro, rd, v0, v1, v2):
        arrays = [f32(a) for a in (ro, rd, v0, v1, v2)]
        n = arrays[0].shape[0]
        t, out = torch.zeros(n), torch.zeros((n, 15))
        self.lib.host_ray_triangle_adj(n, *(a.data_ptr() for a in arrays), t.data_ptr(), out.data_ptr())
        return t, out

    def closest_hit_adj(self, scene, ro, rd, ct_t, ct_n, ct_rgb):
        sv, topo, n_tris, n_verts, n_lights, n_mat = self._scene(scene)
        ro, rd, ct_t, ct_n, ct_rgb = (f32(a) for a in (ro, rd, ct_t, ct_n, ct_rgb))
        n = ro.shape[0]
        c_ro, c_rd = torch.zeros((n, 3)), torch.zeros((n, 3))
        rows = torch.zeros((n, sv.shape[1]))
        hit = torch.zeros(n, dtype=torch.uint8)
        self.lib.host_closest_hit_adj(sv.data_ptr(), topo.data_ptr(), n_tris, n_verts, n_lights, n_mat, sv.shape[1],
                                      n, ro.data_ptr(), rd.data_ptr(), ct_t.data_ptr(), ct_n.data_ptr(),
                                      ct_rgb.data_ptr(), c_ro.data_ptr(), c_rd.data_ptr(), rows.data_ptr(),
                                      hit.data_ptr())
        return c_ro, c_rd, rows, hit.bool()

    def sky_adj(self, scene, rd, ct):
        sv, topo, n_tris, n_verts, n_lights, n_mat = self._scene(scene)
        rd, ct = f32(rd), f32(ct)
        n = rd.shape[0]
        c_rd, rows = torch.zeros((n, 3)), torch.zeros((n, sv.shape[1]))
        self.lib.host_sky_adj(sv.data_ptr(), topo.data_ptr(), n_tris, n_verts, n_lights, n_mat, sv.shape[1], n,
                              rd.data_ptr(), ct.data_ptr(), c_rd.data_ptr(), rows.data_ptr())
        return c_rd, rows


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    lib = build_shim(tmp_path_factory.mktemp("mesh_kernel_bwd_host"), SHIM)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.host_grad_mesh.argtypes = [p, p, i, i, p, p, p, i, i, i, i, i, i, i]
    lib.host_carries_mesh.argtypes = [p, p, i, i, p, i, i, i, i, i, i, i, p, p, p, p]
    lib.host_ray_triangle_adj.argtypes = [i] + [p] * 7
    lib.host_closest_hit_adj.argtypes = [p, p, i, i, i, i, i, i] + [p] * 9
    lib.host_sky_adj.argtypes = [p, p, i, i, i, i, i, i, p, p, p, p]
    return HostMeshAdj(lib)


def _leaf_sv(scene, w=8, h=8):
    sv = MM.pack_mesh_scene(scene, w, h).detach().clone().requires_grad_(True)
    return sv, MM.unpack_mesh_scene(sv, scene)[0].params.unpack()


def roof_scene():
    """Two triangles sharing the edge x = y = 0, |z| <= 1, tilted 45 degrees
    to either side, with a light far off: a ray straight down the y axis
    meets the edge at the same t = 5 in both (every product and sum of the
    test is exact)."""
    p = mesh.default_params()
    verts = [(0.0, 0.0, -1.0), (0.0, 0.0, 1.0), (1.0, -1.0, 0.0), (-1.0, -1.0, 0.0)]
    p = p._replace(
        vertices=V3(*(torch.tensor([q[c] for q in verts]) for c in range(3))),
        tri_idx=torch.tensor([[0, 1, 2], [0, 1, 3]]), tri_mat=torch.tensor([1, 2]),
    )
    return mesh.make_scene(params=p, lights=L.spherical_light((30.0, 20.0, 20.0), 1.0, (3.0, 3.0, 3.0)))


def test_ray_triangle_adjoint_matches_autograd(host):
    """Seeded triangles and rays aimed inside them, and determinants just
    past the guard (|det| 2e-7 to 1e-5: a ray nearly in the triangle's
    plane, where t's derivatives grow as 1/det^2)."""
    rs = np.random.default_rng(21)
    n = 600
    v0, v1, v2 = (rs.uniform(-1.0, 1.0, (n, 3)) for _ in range(3))
    bary = rs.dirichlet([2.0, 2.0, 2.0], n)
    point = bary[:, :1] * v0 + bary[:, 1:2] * v1 + bary[:, 2:] * v2
    ro = point + rs.uniform(-2.0, 2.0, (n, 3))
    rd = (point - ro) / np.linalg.norm(point - ro, axis=1, keepdims=True)
    # the unit triangle in z = 0 and rays of slope c toward (0.25, 0.25, 0): det = c
    m = 40
    c = np.geomspace(2e-7, 1e-5, m)
    flat_rd = np.stack([np.sqrt(1.0 - c * c), np.zeros(m), -c], 1)
    flat = (np.tile([0.0, 0.0, 0.0], (m, 1)), np.tile([1.0, 0.0, 0.0], (m, 1)), np.tile([0.0, 1.0, 0.0], (m, 1)))
    ro = np.concatenate([ro, np.array([0.25, 0.25, 0.0]) - flat_rd * 0.5])
    rd = np.concatenate([rd, flat_rd])
    v0, v1, v2 = (np.concatenate([a, b]) for a, b in zip((v0, v1, v2), flat))
    t, got = host.ray_triangle_adj(ro, rd, v0, v1, v2)
    leaves = [f32(a).requires_grad_(True) for a in (ro, rd, v0, v1, v2)]
    want_t = ray_triangle(*(V3(*a.T) for a in leaves))
    hit = torch.isfinite(want_t)
    assert torch.equal(torch.isfinite(t), hit) and bool(hit[-m:].all()) and float(hit.double().mean()) > 0.95
    np.testing.assert_array_equal(t[hit].numpy(), want_t[hit].detach().numpy())
    grads = torch.autograd.grad(torch.where(hit, want_t, 0.0).sum(), leaves)
    ref = torch.cat(grads, 1).numpy()
    assert_lanes_close(got.numpy()[hit.numpy()], ref[hit.numpy()], "ray_triangle")
    assert np.abs(got.numpy()[n:]).max() > 1e4  # near the guard the derivatives are large


def _closest_hit_ref(scene, ro, rd, ct_t, ct_n, ct_rgb):
    """Autograd of models/mesh.closest_hit on the hits: [hits, 6 + n_sv]
    rows (c_ro, c_rd, d/d sv) of <(ct_t, ct_n, ct_rgb), (t, normal, rgb)>."""
    sv, params = _leaf_sv(scene)
    tro, trd = (f32(a).requires_grad_(True) for a in (ro, rd))
    h = mesh.closest_hit(params, V3(*tro.T), V3(*trd.T))
    hit = torch.isfinite(h.t)
    t = torch.where(hit, h.t, 0.0)
    out = t * f32(ct_t) + sum(h.normal[c] * f32(ct_n[:, c]) + h.material.rgb[c] * f32(ct_rgb[:, c]) for c in range(3))
    mask = hit.numpy()
    eye = torch.eye(len(ro))[mask]
    g_ro, g_rd, g_sv = torch.autograd.grad(out, [tro, trd, sv], grad_outputs=eye, is_grads_batched=True)
    rows_of = lambda g: g[np.arange(len(eye)), np.flatnonzero(mask)].numpy()
    return hit, np.concatenate([rows_of(g_ro), rows_of(g_rd), g_sv[:, 0].numpy()], 1)


def test_closest_hit_adjoint_matches_autograd(host):
    """The winner's t, face-forward normal and material, per ray, at seeded
    rays through the demo mesh (with the apex moved) for random cotangents."""
    from test_torch_mesh import scene_rays

    scene = mesh.make_scene()
    scene.params.vertices.x[16], scene.params.vertices.y[16] = 1.1, 1.2
    ro, rd = (a.T.astype(np.float32) for a in scene_rays(500, 23))
    rs = np.random.default_rng(24)
    ct_t, ct_n, ct_rgb = rs.standard_normal(len(ro)), rs.standard_normal(ro.shape), rs.standard_normal(ro.shape)
    c_ro, c_rd, rows, hit = host.closest_hit_adj(scene, ro, rd, ct_t, ct_n, ct_rgb)
    want_hit, ref = _closest_hit_ref(scene, ro, rd, ct_t, ct_n, ct_rgb)
    assert torch.equal(hit, want_hit) and 0.3 < float(hit.double().mean()) < 0.95
    lanes = np.concatenate([c_ro.numpy(), c_rd.numpy(), rows.numpy()], 1)[hit.numpy()]
    assert_lanes_close(lanes, ref, "closest hit")
    # every vertex of the pyramid and the cube gets gradient from some ray
    verts = rows.numpy()[:, 12:12 + 51].reshape(len(ro), 17, 3)
    assert (np.abs(verts).max(axis=(0, 2)) > 0).all()


def test_shared_edge_first_triangle_takes_all(host):
    """A ray meeting an edge two triangles share at one exact t: t, its
    gradient, the normal and the material are the first triangle's (the
    first minimum, strict <), as in K1 and JAX; an even split of ct_t, as
    jnp.min gives, would move the shared vertices' x gradient to 0."""
    scene = roof_scene()
    ro = np.array([[0.0, 5.0, 0.0], [0.0, 5.0, 0.5], [0.0, 5.0, -0.25]], np.float32)
    rd = np.tile(np.array([[0.0, -1.0, 0.0]], np.float32), (3, 1))
    sv, params = _leaf_sv(scene)
    ts = mesh._tri_ts(params, V3(*f32(ro).T), V3(*f32(rd).T))
    assert torch.equal(ts[:, 0], ts[:, 1]) and torch.equal(ts[:, 0], torch.full((3,), 5.0))
    ct_t, ct_n, ct_rgb = np.ones(3), np.tile([[0.3, -0.7, 0.2]], (3, 1)), np.tile([[0.5, 0.25, -1.0]], (3, 1))
    c_ro, c_rd, rows, hit = host.closest_hit_adj(scene, ro, rd, ct_t, ct_n, ct_rgb)
    want_hit, ref = _closest_hit_ref(scene, ro, rd, ct_t, ct_n, ct_rgb)
    assert bool(hit.all()) and bool(want_hit.all())
    lanes = np.concatenate([c_ro.numpy(), c_rd.numpy(), rows.numpy()], 1)
    assert_lanes_close(lanes, ref, "shared edge")
    verts = rows.numpy()[:, 12:24].reshape(3, 4, 3)
    assert (np.abs(verts[:, 2]).max(axis=1) > 0).all()  # the first triangle's third vertex
    assert (verts[:, 3] == 0).all()  # the second's gets nothing
    assert (np.abs(verts[:, :2, 0]) > 1e-3).all()  # an even split of ct_t would cancel these
    mat1, mat2 = sv.shape[1] - 40, sv.shape[1] - 20  # the records of materials 1 and 2 (of 3)
    assert (rows.numpy()[:, mat1:mat1 + 3] != 0).all() and (rows.numpy()[:, mat2:mat2 + 3] == 0).all()


def test_sky_adjoint_matches_autograd(host):
    scene = mesh.make_scene()
    rs = np.random.default_rng(25)
    rd = rs.normal(size=(64, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    ct = rs.standard_normal(rd.shape).astype(np.float32)
    c_rd, rows = host.sky_adj(scene, rd, ct)
    sv, params = _leaf_sv(scene)
    trd = f32(rd).requires_grad_(True)
    out = analytical.background(params, V3(*trd.T))
    out = sum(out[c] * f32(ct[:, c]) for c in range(3))
    (g_rd,) = torch.autograd.grad(out.sum(), trd, retain_graph=True)
    (g_sv,) = torch.autograd.grad(out, sv, grad_outputs=torch.eye(len(rd)), is_grads_batched=True)
    assert_lanes_close(c_rd.numpy(), g_rd.numpy(), "rd")
    assert_lanes_close(rows.numpy(), g_sv[:, 0].numpy(), "sv")


def _moved_apex_two_lights(depth):
    """The demo with the pyramid's apex moved and a rectangular light beside
    the spherical one."""
    scene = mesh.make_scene(recursion_depth=depth, lights=L.concat_lights(
        L.spherical_light((3.0, 2.0, 2.0), 1.0, (3.0, 3.0, 3.0)),
        L.rect_light((-2.0, 3.0, -1.0), (1.0, 0.0, 0.0), (0.0, 0.0, 1.0), (2.0, 2.0, 2.0)),
    ))
    scene.params.vertices.x[16], scene.params.vertices.y[16] = 1.1, 1.2
    return scene


CASES = {
    "d2_spp1_verbatim": (lambda: mesh.make_scene(recursion_depth=2), 1, VERBATIM),
    "d3_spp1_fixed": (lambda: mesh.make_scene(recursion_depth=3), 1, FIXED),
    "d2_spp2_verbatim": (lambda: mesh.make_scene(recursion_depth=2), 2, VERBATIM),
    "d2_spp2_fixed": (lambda: mesh.make_scene(recursion_depth=2), 2, FIXED),
    "d3_spp1_moved_apex_two_lights": (lambda: _moved_apex_two_lights(3), 1, VERBATIM),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_mesh_backward_code_matches_autograd(host, case):
    """Whole frames at 24x16 against autograd of the plain version."""
    make, spp, quirks = CASES[case]
    scene = make()
    w, h = 24, 16
    seed = sorted(CASES).index(case) + 61
    key = rng.prng_key(seed)
    ct = torch.from_numpy(np.random.default_rng(seed).standard_normal((h, w, 4)).astype(np.float32))
    sv, grad = host.grad(scene, key, ct, w, h, spp, quirks)
    ref = MK.render_grad_reference(sv, scene, key, ct, w, h, spp, quirks)
    assert_grad_close(grad, ref)
    assert np.abs(grad.numpy()[0, 12:12 + 51]).max() > 0  # the vertices carry gradient


@pytest.mark.parametrize("case", ["d2_spp2_fixed", "d3_spp1_moved_apex_two_lights"])
def test_mesh_records_carry_what_bounce_hands_on(host, case):
    """K2's record step with MeshAdj writes the carry tracer.cuh's bounce
    with Mesh hands on: its winner is K1's triangle."""
    make, spp, quirks = CASES[case]
    assert_carries_equal(*host.carries(make(), rng.prng_key(sorted(CASES).index(case) + 61), 24, 16, spp, quirks))


def _looking_at_light(light_at, camera_from, radius, depth=2):
    """The demo mesh seen through a narrow camera whose every ray meets the
    light (radius `radius` at `light_at`) before anything else."""
    scene = mesh.make_scene(recursion_depth=depth, lights=L.spherical_light(light_at, radius, (3.0, 3.0, 3.0)))
    return scene.replace(camera=Pinhole(origin=v3(*camera_from), center=v3(*light_at), fov=torch.tensor(4.0)))


LIGHT_CASES = {
    # rays leave the scene upward: past the light there is only sky, so the
    # mesh is missed and its triangle 0's normal stands unused
    "miss_sees_the_light": lambda: _looking_at_light((0.0, 4.0, 0.0), (0.0, 1.0, 3.0), 0.5),
    # the light between the camera and the cube: em_hit wins over the mesh hit
    "light_in_front_of_the_mesh": lambda: _looking_at_light((-1.2, -0.35, 1.5), (-1.2, -0.35, 4.0), 0.4),
}


@pytest.mark.parametrize("case", sorted(LIGHT_CASES))
def test_light_hits_give_the_vertices_nothing(host, case):
    """Every camera ray meets the light first (past it the sky, or the
    cube): the vertices get exactly zero, in the kernel code as in
    autograd, and the light's emission gets the gradient (FIXED: VERBATIM
    renders a light seen directly black)."""
    quirks = FIXED
    scene = LIGHT_CASES[case]()
    w, h = 8, 6
    key = rng.prng_key(71)
    ct = torch.from_numpy(np.random.default_rng(71).standard_normal((h, w, 4)).astype(np.float32))
    sv, grad = host.grad(scene, key, ct, w, h, 1, quirks)
    ref = MK.render_grad_reference(sv, scene, key, ct, w, h, 1, quirks)
    lights_at = 12 + 3 * 17 + 7
    assert (grad.numpy()[0, 12:lights_at] == 0).all() and (ref.numpy()[0, 12:lights_at] == 0).all()
    assert (np.abs(grad.numpy()[0, lights_at + 3:lights_at + 6]) > 0).all()
    assert_grad_close(grad, ref)

