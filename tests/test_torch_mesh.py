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
minute: JAX compiles the unrolled triangle chain); their guard is marked
`slow`.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pathtracer_tpu as pt
from pathtracer_tpu.models import mesh as JM
from pathtracer_tpu.ops.intersect import ray_triangle as jax_ray_triangle
from pathtracer_tpu.ops.megakernel_mesh import pack_mesh_scene as jax_pack_mesh_scene
from pathtracer_tpu.ops.vecmath import V3 as JV3
from pathtracer_tpu.utils.sceneio import scene_to_dict
from pathtracer_tpu_torch.integrator import tracer as T
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
    autograd to the vertices; on the card the gradient raises until K7
    runs inside K2."""
    scene = TM.make_scene(recursion_depth=2)
    launches = MK.render_frame_megakernel.launches
    img = MK.render_frame_megakernel(scene, rng.prng_key(6), 16, 8)
    assert MK.render_frame_megakernel.launches == launches
    assert torch.equal(img, MK.render_frame_reference(scene, rng.prng_key(6), 16, 8))
    scene.params.vertices.y.requires_grad_(True)
    (g,) = torch.autograd.grad(MK.render_frame_megakernel(scene, rng.prng_key(6), 16, 8).sum(),
                               scene.params.vertices.y)
    assert torch.isfinite(g).all() and float(g.abs().sum()) > 0
    with pytest.raises(NotImplementedError, match="ROADMAP item 12"):
        MK._require_backward("mesh")


if __name__ == "__main__":
    jax.config.update("jax_enable_x64", True)
    for path, frame in jax_frames().items():
        np.save(path, frame)
