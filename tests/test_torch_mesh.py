"""The port's small triangle-mesh scene (`models/mesh.py`,
`ops/intersect.ray_triangle`, `ops/megakernel_mesh`) held to the JAX
package's.

Möller-Trumbore elementwise against JAX: float64 to rtol 1e-12 on the same
hit set, float32 on well-conditioned inputs (hits inside the triangle and
misses well outside it; XLA on the CPU contracts a*b+c into FMAs and torch
does not, so a hit within an ulp of an edge may land on the other side).
The topology (vertices, indices, material ids) equal to JAX's. The closest
and any hit on seeded rays through the scene: float64 equal triangle for
triangle, float32 with the rate of edge flips (a ray whose winner differs)
stated and bounded. Frames: the float64 eager frame against the committed
JAX render tests/golden_torch/mesh_64x32_d4_k7_f64.npy at rtol 1e-9, and
the float32 one against tests/golden_torch/mesh_64x48_d4_k3.npy (JAX's
`pt.render_frame(make_scene(), PRNGKey(3), 64, 48)`, which chip_smoke.py
holds K1's mesh backend to) within the image gate. Regenerate both with
`JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_mesh.py` (about a
minute: JAX compiles the unrolled triangle chain, and then the gradient
below); their guard is marked `slow`.

The gradient the backward kernel's mesh backend is held to: torch autograd
of the eager `render_frame(detach=True)` with respect to every float leaf
(the 17 vertices, camera, sky, light, materials) against
tests/golden_torch/grad_mesh_64x48_d4_k3.npz, jax.grad of mean(rgb^2) of
JAX's render_frame(detach=True, remat=True) at 64x48, depth 4, PRNGKey(3),
at tests/test_torch_grad.py's tolerances (rtol 1e-2 / atol 1e-7 for the
vertices and the camera, rtol 5e-3 / atol 1e-8 for the rest);
chip_smoke.py phase 22 holds K2 to it. JAX runs that gradient op by op
(`jax.disable_jit`): XLA's compile of it outgrew 10 GB of host memory at
16x12, depth 1. The eager closest hit takes JAX's tie rule, the first
minimum: at an edge two triangles share, t and its whole gradient are the
first triangle's (torch.amin would share the gradient).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pathtracer_tpu as pt
from pathtracer_tpu.integrator.inverse import select_leaves as jax_select_leaves
from pathtracer_tpu.models import mesh as JM
from pathtracer_tpu.ops.intersect import ray_triangle as jax_ray_triangle
from pathtracer_tpu.ops.megakernel_mesh import pack_mesh_scene as jax_pack_mesh_scene
from pathtracer_tpu.ops.vecmath import V3 as JV3
from pathtracer_tpu.utils.sceneio import scene_to_dict
from pathtracer_tpu_torch.integrator import tracer as T
from pathtracer_tpu_torch.integrator.inverse import named_leaves
from pathtracer_tpu_torch.models import mesh as TM
from pathtracer_tpu_torch.ops import megakernel as MK
from pathtracer_tpu_torch.ops import rng
from pathtracer_tpu_torch.ops.intersect import ray_triangle
from pathtracer_tpu_torch.ops.megakernel_mesh import mesh_topology, pack_mesh_scene, unpack_mesh_scene
from pathtracer_tpu_torch.ops.vecmath import V3
from pathtracer_tpu_torch.utils.sceneio import scene_from_dict
from test_torch_kernel_host import one_torch_thread  # noqa: F401
from test_torch_render import assert_image_close

GOLDEN = os.path.join(os.path.dirname(__file__), "golden_torch")
FIXTURE = os.path.join(GOLDEN, "mesh_64x48_d4_k3.npy")
F64_FIXTURE = os.path.join(GOLDEN, "mesh_64x32_d4_k7_f64.npy")
GRAD_FIXTURE = os.path.join(GOLDEN, "grad_mesh_64x48_d4_k3.npz")
GEOMETRY = ("params.vertices", "camera")
DTYPES = {"f64": (jnp.float64, torch.float64), "f32": (jnp.float32, torch.float32)}
pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _jv3(a, dtype):
    return JV3(*(jnp.asarray(c, dtype) for c in a))


def _tv3(a, dtype):
    return V3(*(torch.tensor(c, dtype=dtype) for c in a))


def scene_rays(n: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """Seeded rays from around the camera and from points above the ground
    toward the scene: [3, n] origins and unit directions."""
    rs = np.random.default_rng(seed)
    ro = np.where(rs.random(n) < 0.5, rs.uniform(-0.4, 0.4, (3, n)) + np.array([[0.0], [0.3], [5.0]]),
                  rs.uniform(-2.5, 2.5, (3, n)) * np.array([[1.0], [0.3], [1.0]]) + np.array([[0.0], [1.5], [0.0]]))
    target = rs.uniform(-2.0, 2.0, (3, n)) * np.array([[1.0], [0.6], [1.0]]) + np.array([[0.0], [-0.4], [0.0]])
    rd = target - ro
    return ro, rd / np.linalg.norm(rd, axis=0)


def test_ray_triangle_closed_form():
    """The unit triangle in z = 0: a hit at the centroid, from behind too
    (two-sided), a miss outside it and for a parallel ray."""
    tri = [V3(*(torch.tensor(c) for c in v)) for v in ((0.0, 0.0, 0.0), (1.0, 0.0, 0.0), (0.0, 1.0, 0.0))]
    v = lambda *c: V3(*(torch.tensor(x) for x in c))
    assert float(ray_triangle(v(0.25, 0.25, 1.0), v(0.0, 0.0, -1.0), *tri)) == pytest.approx(1.0, rel=1e-6)
    assert float(ray_triangle(v(0.25, 0.25, -2.0), v(0.0, 0.0, 1.0), *tri)) == pytest.approx(2.0, rel=1e-6)
    assert not np.isfinite(float(ray_triangle(v(0.9, 0.9, 1.0), v(0.0, 0.0, -1.0), *tri)))
    assert not np.isfinite(float(ray_triangle(v(0.2, 0.2, 1.0), v(1.0, 0.0, 0.0), *tri)))


@pytest.mark.parametrize("prec", ["f64", "f32"])
def test_ray_triangle_matches_jax(prec):
    """Random triangles and rays, elementwise. float32: rays aimed at
    barycentric points at least 0.05 inside or outside an edge."""
    jdt, tdt = DTYPES[prec]
    rs = np.random.default_rng(3)
    n = 4000
    v0, v1, v2 = (rs.uniform(-1.0, 1.0, (3, n)) for _ in range(3))
    bary = rs.uniform(-0.5, 1.0, (2, n))
    if prec == "f32":
        inside = (bary.min(axis=0) > 0.05) & (bary.sum(axis=0) < 0.95)
        outside = (bary.min(axis=0) < -0.05) | (bary.sum(axis=0) > 1.05)
        keep = inside | outside
        v0, v1, v2, bary = v0[:, keep], v1[:, keep], v2[:, keep], bary[:, keep]
    point = v0 + bary[0] * (v1 - v0) + bary[1] * (v2 - v0)
    ro = point + rs.uniform(-2.0, 2.0, point.shape)
    rd = (point - ro) / np.linalg.norm(point - ro, axis=0)
    want = np.asarray(jax_ray_triangle(*(_jv3(a, jdt) for a in (ro, rd, v0, v1, v2))))
    got = ray_triangle(*(_tv3(a, tdt) for a in (ro, rd, v0, v1, v2))).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    hit = np.isfinite(want)
    assert 0.1 < hit.mean() < 0.9
    np.testing.assert_allclose(got[hit], want[hit], rtol=1e-12 if prec == "f64" else 1e-5)


def test_topology_matches_jax():
    jp, tp = JM.default_params(), TM.default_params()
    assert [tuple(t) for t in tp.tri_idx.tolist()] == list(jp.tri_idx)
    assert tp.tri_mat.tolist() == list(jp.tri_mat)
    assert tp.tri_idx.shape == (20, 3) and tp.vertices.x.shape == (17,)
    for c in "xyz":
        np.testing.assert_array_equal(getattr(tp.vertices, c).numpy(), np.asarray(getattr(jp.vertices, c)))
    topo = mesh_topology(TM.make_scene())[0]
    assert topo.dtype == torch.int32 and topo.shape == (20, 4)
    assert torch.equal(topo[:, :3].long(), tp.tri_idx) and torch.equal(topo[:, 3].long(), tp.tri_mat)


@pytest.mark.parametrize("prec", ["f64", "f32"])
def test_closest_and_any_hit_match_jax(prec):
    """20,000 seeded rays through the scene: t, the face-forward normal, the
    material and the shadow test. float64: every ray equal (the same
    winner, t to rtol 1e-12). float32: winners may flip at a shared edge
    or a tie between coplanar triangles; at most 0.1% do (0 of 20,000 here,
    and 0 shadow tests differ, when this test was written), and the rest
    agree to rtol 1e-5."""
    jdt, tdt = DTYPES[prec]
    ro, rd = scene_rays(20000, 11)
    jh = JM.closest_hit(JM.default_params(jdt), _jv3(ro, jdt), _jv3(rd, jdt))
    th = TM.closest_hit(TM.default_params(tdt), _tv3(ro, tdt), _tv3(rd, tdt))
    jt, tt = np.asarray(jh.t), th.t.numpy()
    jn = np.stack([np.asarray(c) for c in jh.normal])
    tn = np.stack([c.numpy() for c in th.normal])
    jrgb = np.stack([np.asarray(c) for c in jh.material.rgb])
    trgb = np.stack([c.numpy() for c in th.material.rgb])
    hit = np.isfinite(jt)
    assert 0.3 < hit.mean() < 0.95
    same = (np.isfinite(tt) == hit) & (np.abs(tn - jn).max(axis=0) < 1e-4) & (np.abs(trgb - jrgb).max(axis=0) == 0)
    if prec == "f64":
        assert same.all()
        np.testing.assert_allclose(tt[hit], jt[hit], rtol=1e-12)
        np.testing.assert_allclose(tn, jn, rtol=0, atol=1e-14)
    else:
        assert (~same).mean() <= 1e-3
        both = same & hit
        np.testing.assert_allclose(tt[both], jt[both], rtol=1e-5)
    max_dist = np.random.default_rng(12).uniform(0.5, 8.0, ro.shape[1])
    ja = np.asarray(JM.any_hit(JM.default_params(jdt), _jv3(ro, jdt), _jv3(rd, jdt), jnp.asarray(max_dist, jdt)))
    ta = TM.any_hit(TM.default_params(tdt), _tv3(ro, tdt), _tv3(rd, tdt), torch.tensor(max_dist, dtype=tdt)).numpy()
    assert (ta != ja).mean() <= (0 if prec == "f64" else 1e-3)
    assert 0.1 < ja.mean() < 0.9


def _edited_jax_scene():
    """The demo with the pyramid's apex moved and other leaves edited."""
    s = JM.make_scene(recursion_depth=4)
    p = s.params
    f32 = jnp.float32
    verts = p.vertices._replace(x=p.vertices.x.at[16].set(1.1), y=p.vertices.y.at[16].set(1.3))
    p = p._replace(
        vertices=verts, sky_scale=jnp.asarray(0.6, f32),
        materials=p.materials._replace(roughness=jnp.asarray([0.5, 0.2, 0.3], f32)),
    )
    lights = s.lights._replace(emission=s.lights.emission._replace(x=jnp.asarray([4.0], f32)))
    return s.replace(params=p, lights=lights)


def test_scene_from_dict_carries_an_edited_mesh_scene():
    """Every float leaf crosses (a moved vertex among them); the topology is
    the family default's, as in JAX."""
    jax_scene = _edited_jax_scene()
    scene = scene_from_dict(scene_to_dict(jax_scene, "mesh"))
    assert scene.closest_hit_fn is TM.closest_hit and scene.recursion_depth == 4
    for section in ("params", "lights", "camera"):
        want = {jax.tree_util.keystr(k): np.asarray(v)
                for k, v in jax.tree_util.tree_flatten_with_path(getattr(jax_scene, section))[0]}
        got = {"." + k: v.numpy() for k, v in getattr(scene, section).named_buffers(remove_duplicate=False)}
        assert sorted(set(got) - {".tri_idx", ".tri_mat"}) == sorted(want), section
        for path, w in want.items():
            np.testing.assert_array_equal(got[path], w, err_msg=section + path)
    assert [tuple(t) for t in scene.params.tri_idx.tolist()] == list(jax_scene.params.tri_idx)
    assert float(scene.params.vertices.x[16]) == pytest.approx(1.1)


@pytest.mark.parametrize("with_medium", [False, True])
def test_pack_mesh_scene_matches_jax(with_medium):
    jax_scene = _edited_jax_scene()
    scene = scene_from_dict(scene_to_dict(jax_scene, "mesh"))
    ref = np.asarray(jax_pack_mesh_scene(jax_scene, 64, 48, with_medium=with_medium))
    got = pack_mesh_scene(scene, 64, 48, with_medium=with_medium).numpy()
    assert got.shape == ref.shape == (1, 12 + 51 + 7 + 15 + (26 if with_medium else 20) * 3)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)  # the camera basis may differ by ulps
    # the inverse gives back the scene's leaves, and a frame of it is the scene's frame
    sv = pack_mesh_scene(scene, 16, 8)
    back, _ = unpack_mesh_scene(sv, scene)
    for (name, a), (_, b) in zip(back.named_buffers(), scene.named_buffers()):
        assert torch.equal(a, b), name
    assert torch.equal(MK.render_frame_packed(sv, scene, rng.prng_key(2), 16, 8),
                       MK.render_frame_reference(scene, rng.prng_key(2), 16, 8))


def jax_frames() -> dict:
    """The fixtures as JAX renders them today (jax_enable_x64 on)."""
    return {
        FIXTURE: np.asarray(pt.render_frame(JM.make_scene(), jax.random.PRNGKey(3), 64, 48)),
        F64_FIXTURE: np.asarray(pt.render_frame(JM.make_scene(dtype=jnp.float64), jax.random.PRNGKey(7), 64, 32)),
    }


def test_f64_eager_frame_matches_jax_fixture():
    img = T.render_frame(TM.make_scene(dtype=torch.float64), rng.prng_key(7), 64, 32)
    assert img.dtype == torch.float64
    np.testing.assert_allclose(img.numpy(), np.load(F64_FIXTURE), rtol=1e-9, atol=1e-12)


def test_f32_eager_frame_matches_jax_fixture():
    img = T.render_frame(TM.make_scene(), rng.prng_key(3), 64, 48)
    assert img.dtype == torch.float32
    assert_image_close(img, np.load(FIXTURE))


@pytest.mark.slow
def test_fixtures_are_what_jax_computes():
    # chip_smoke.py holds K1's mesh backend to the float32 file on the card,
    # where JAX is absent; both must stay what JAX renders today.
    for path, frame in jax_frames().items():
        np.testing.assert_allclose(np.load(path), frame, rtol=0, atol=1e-12, err_msg=path)


def test_megakernel_cpu_path_is_the_plain_version_with_autograd():
    """On the CPU the wrapper is the plain version, which keeps eager
    autograd to the vertices; on the card K2 takes the mesh, and only the
    big mesh's gradient raises."""
    scene = TM.make_scene(recursion_depth=2)
    launches = MK.render_frame_megakernel.launches
    img = MK.render_frame_megakernel(scene, rng.prng_key(6), 16, 8)
    assert MK.render_frame_megakernel.launches == launches
    assert torch.equal(img, MK.render_frame_reference(scene, rng.prng_key(6), 16, 8))
    scene.params.vertices.y.requires_grad_(True)
    (g,) = torch.autograd.grad(MK.render_frame_megakernel(scene, rng.prng_key(6), 16, 8).sum(),
                               scene.params.vertices.y)
    assert torch.isfinite(g).all() and float(g.abs().sum()) > 0
    MK._require_backward("mesh")
    with pytest.raises(NotImplementedError, match="ROADMAP item 12"):
        MK._require_backward("bigmesh")


def full_grad_close(got, want, name) -> bool:
    """tests/test_torch_grad.py's tolerances, the geometry's for the
    vertices and the camera."""
    rtol, atol = (1e-2, 1e-7) if name.startswith(GEOMETRY) else (5e-3, 1e-8)
    return bool(np.all(np.abs(np.asarray(got, np.float64) - want) <= atol + rtol * np.abs(want)))


def jax_mesh_grads() -> dict:
    """jax.grad of mean(img[..., :3]**2) of JAX's render_frame(detach=True,
    remat=True) on the mesh demo (float32, depth 4, 64x48, PRNGKey(3)) with
    respect to every float leaf, keyed by its dotted path; op by op."""
    train, rebuild, names = jax_select_leaves(JM.make_scene(dtype=jnp.float32, recursion_depth=4), ("",))

    def loss(tv):
        img = pt.render_frame(rebuild(tv), jax.random.PRNGKey(3), 64, 48, detach=True, remat=True)
        return jnp.mean(img[..., :3] ** 2)

    with jax.disable_jit():
        return {n: np.asarray(g) for n, g in zip(names, jax.grad(loss)(train))}


def test_eager_grad_of_every_leaf_matches_jax_fixture():
    scene = TM.make_scene()
    leaves = dict(named_leaves(scene))
    with np.load(GRAD_FIXTURE) as data:
        want = {k: data[k] for k in data.files}
    assert sorted(want) == sorted(n for n, leaf in leaves.items() if leaf.is_floating_point())
    names = sorted(want)
    for n in names:
        leaves[n].requires_grad_(True)
    img = T.render_frame(scene, rng.prng_key(3), 64, 48, detach=True)
    grads = torch.autograd.grad((img[..., :3] ** 2).mean(), [leaves[n] for n in names], allow_unused=True)
    for n, g in zip(names, grads):
        got = np.zeros(want[n].shape) if g is None else g.numpy()
        assert full_grad_close(got, want[n], n), (n, got, want[n])
    # the vertices carry gradient (the hit distance and the normal), the
    # pyramid's apex in every coordinate
    for c in "xyz":
        assert np.abs(want[f"params.vertices.{c}"]).max() > 1e-3 and want[f"params.vertices.{c}"][16] != 0, c


@pytest.mark.slow
def test_grad_fixture_is_what_jax_computes():
    """About three minutes on a CPU (JAX op by op). Bit for bit: the op by
    op run has no compile to vary. Regenerate with `JAX_PLATFORMS=cpu
    PYTHONPATH=. python tests/test_torch_mesh.py`."""
    want = jax_mesh_grads()
    with np.load(GRAD_FIXTURE) as got:
        assert sorted(got.files) == sorted(want)
        for n in want:
            np.testing.assert_array_equal(got[n], want[n], err_msg=n)


def _roof(jax_side: bool):
    """Two triangles sharing the edge x = y = 0, |z| <= 1, tilted 45
    degrees to either side, in the JAX or the port's params."""
    verts = [(0.0, 0.0, -1.0), (0.0, 0.0, 1.0), (1.0, -1.0, 0.0), (-1.0, -1.0, 0.0)]
    if jax_side:
        return dataclasses.replace(JM.default_params(jnp.float32), vertices=_jv3(np.array(verts).T, jnp.float32),
                                   tri_idx=((0, 1, 2), (0, 1, 3)), tri_mat=(1, 2))
    return TM.default_params()._replace(vertices=_tv3(np.array(verts).T, torch.float32),
                                        tri_idx=torch.tensor([[0, 1, 2], [0, 1, 3]]), tri_mat=torch.tensor([1, 2]))


def test_shared_edge_tie_gives_the_first_triangle_everything_as_jax():
    """Rays down the y axis meet the roof's shared edge at t = 5 in both
    triangles (exact arithmetic): the gradient of t and the normal is the
    first triangle's alone in JAX's where-chain, and in the port."""
    ro = np.array([[0.0, 0.0, 0.0], [5.0, 5.0, 5.0], [0.0, 0.5, -0.25]])
    rd = np.array([[0.0, 0.0, 0.0], [-1.0, -1.0, -1.0], [0.0, 0.0, 0.0]])
    ct_n = np.array([0.3, -0.7, 0.2])

    def jax_out(vx, vy, vz):
        p = dataclasses.replace(_roof(True), vertices=JV3(vx, vy, vz))
        h = JM.closest_hit(p, _jv3(ro, jnp.float32), _jv3(rd, jnp.float32))
        return jnp.sum(h.t + sum(getattr(h.normal, c) * w for c, w in zip("xyz", ct_n)))

    jv = _roof(True).vertices
    want = jax.grad(jax_out, argnums=(0, 1, 2))(jv.x, jv.y, jv.z)
    p = _roof(False)
    leaves = [c.requires_grad_(True) for c in p.vertices]
    h = TM.closest_hit(p._replace(vertices=V3(*leaves)), _tv3(ro, torch.float32), _tv3(rd, torch.float32))
    assert torch.equal(h.t, torch.full((3,), 5.0))
    got = torch.autograd.grad((h.t + sum(n * w for n, w in zip(h.normal, ct_n))).sum(), leaves)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)
    assert float(got[0][0]) != 0.0 and float(got[0][3]) == 0.0  # vertex 3 is the second triangle's alone


def test_vertex_gradient_matches_central_differences():
    """The eager mesh gradient to the pyramid apex's y against CRN central
    differences (the same key, so the same uniforms), as the JAX package's
    tests/test_bigmesh.py checks its big mesh: the detached estimator
    leaves out the silhouette's moving visibility, so sign and a loose
    magnitude only."""
    scene = TM.make_scene(recursion_depth=2)
    key, (w, h), j, eps = rng.prng_key(11), (48, 32), 16, 3e-3

    def loss(vy):
        p = scene.params.unpack()
        s = scene.replace(params=p._replace(vertices=p.vertices._replace(y=vy)))
        return (T.render_frame(s, key, w, h, detach=True)[..., :3] ** 2).mean()

    vy0 = scene.params.vertices.y.detach().clone()
    vy = vy0.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(loss(vy), vy)
    assert torch.isfinite(g).all()
    bump = torch.zeros_like(vy0)
    bump[j] = eps
    with torch.no_grad():
        fd = float((loss(vy0 + bump) - loss(vy0 - bump)) / (2 * eps))
    an = float(g[j])
    assert np.isfinite(fd) and an != 0.0
    assert fd * an > 0 or abs(fd - an) < 5e-3
    assert abs(fd - an) <= 0.5 * max(abs(fd), abs(an)) + 5e-3


if __name__ == "__main__":
    jax.config.update("jax_enable_x64", True)
    for path, frame in jax_frames().items():
        np.save(path, frame)
    np.savez(GRAD_FIXTURE, **jax_mesh_grads())
