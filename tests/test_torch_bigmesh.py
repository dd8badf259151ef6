"""The port's big triangle-mesh scene (`models/bigmesh.py`,
`ops/megakernel_bigmesh`) held to the JAX package's.

The topology (the UV sphere, the Morton order, the material ids) equal to
JAX's integer for integer; `coef_tables` equal to JAX's bit for bit in
float32 and float64 (the tables are float32 in both); `mt_terms` and
`mt_hit_t` elementwise, float64 tight, float32 on well-conditioned pairs.
The closest and any hit on seeded rays: float64 equal ray for ray, float32
with the rate of edge flips stated and bounded. The plain version walks
blocks of rays and must equal one block bit for bit. The per-ray chunk cull
(replayed by `tools/work.bigmesh_walk`, what K8 walks) never drops the
winner's chunk. Frames against
committed JAX renders: float32 tests/golden_torch/bigmesh_64x48_d4_k3.npy
within the image gate (chip_smoke.py holds K1's big mesh backend to it),
and float64 tests/golden_torch/bigmesh_64x32_d4_k7_f64.npy within 1e-6:
JAX normalises the float32 normal of the table under jit with XLA's own
float32 arithmetic, one ulp off the op-by-op value, which the port's
closest hit equals bit for bit. Regenerate the fixtures with
`JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_bigmesh.py`.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pathtracer_tpu as pt
from pathtracer_tpu.models import bigmesh as JB
from pathtracer_tpu.ops.megakernel_bigmesh import pack_bigmesh_scene as jax_pack_bigmesh_scene
from pathtracer_tpu.ops.vecmath import V3 as JV3
from pathtracer_tpu.utils.sceneio import scene_to_dict
from pathtracer_tpu_torch.integrator import tracer as T
from pathtracer_tpu_torch.models import bigmesh as TB
from pathtracer_tpu_torch.ops import megakernel as MK
from pathtracer_tpu_torch.ops import rng
from pathtracer_tpu_torch.ops.megakernel_bigmesh import bigmesh_counts, bigmesh_tables, pack_bigmesh_scene
from pathtracer_tpu_torch.ops.megakernel_bigmesh import unpack_bigmesh_scene
from pathtracer_tpu_torch.ops.vecmath import V3
from pathtracer_tpu_torch.tools.work import bigmesh_walk
from pathtracer_tpu_torch.utils.sceneio import scene_from_dict
from test_torch_kernel_host import one_torch_thread  # noqa: F401
from test_torch_mesh import scene_rays
from test_torch_render import assert_image_close

GOLDEN = os.path.join(os.path.dirname(__file__), "golden_torch")
FIXTURE = os.path.join(GOLDEN, "bigmesh_64x48_d4_k3.npy")
F64_FIXTURE = os.path.join(GOLDEN, "bigmesh_64x32_d4_k7_f64.npy")
DTYPES = {"f64": (jnp.float64, torch.float64), "f32": (jnp.float32, torch.float32)}
pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _jv3(a, dtype):
    return JV3(*(jnp.asarray(c, dtype) for c in a))


def _tv3(a, dtype):
    return V3(*(torch.tensor(c, dtype=dtype) for c in a))


def test_topology_matches_jax():
    verts, tris = TB.uv_sphere((0.0, 0.0, 0.0), 1.0)
    jverts, jtris = JB.uv_sphere((0.0, 0.0, 0.0), 1.0)
    assert tris == jtris and len(tris) == 1088
    np.testing.assert_array_equal(np.asarray(verts), np.asarray(jverts))
    np.testing.assert_array_equal(TB.morton_order(verts, tris), JB.morton_order(jverts, jtris))
    gv, gt = TB.grid_quad((-6.0, -1.0, -6.0), (12.0, 0.0, 0.0), (0.0, 0.0, 12.0), 4, 4)
    assert (gv, gt) == JB.grid_quad((-6.0, -1.0, -6.0), (12.0, 0.0, 0.0), (0.0, 0.0, 12.0), 4, 4)
    for grid in (0, 4):
        jp, tp = JB.default_params(ground_grid=grid), TB.default_params(ground_grid=grid)
        for name in ("tri_a", "tri_b", "tri_c", "tri_mat"):
            assert getattr(tp, name).tolist() == list(getattr(jp, name)), name
        for c in "xyz":
            np.testing.assert_array_equal(getattr(tp.vertices, c).numpy(), np.asarray(getattr(jp.vertices, c)))
    tp = TB.default_params()
    assert (TB.num_tris(tp), TB.tpad(tp)) == (1090, 1152)
    assert bigmesh_counts(TB.make_scene()) == (9,)


@pytest.mark.parametrize("prec", ["f64", "f32"])
def test_coef_tables_match_jax(prec):
    """Bit for bit: each product is its own op on both sides (no fused
    cross product), and the tables are float32 on both."""
    jdt, tdt = DTYPES[prec]
    want = JB.coef_tables(JB.default_params(jdt))
    got = TB.coef_tables(TB.default_params(tdt))
    for name, w, g in zip(("coef", "attrT"), want, got):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2], np.float32))
    assert [t.shape for t in bigmesh_tables(TB.make_scene())] == [(1152, 16), (8, 1152), (9, 8)]


@pytest.mark.parametrize("prec", ["f64", "f32"])
def test_mt_terms_match_jax(prec):
    """The pair terms and t for 1,000 rays against all 1,152 rows,
    elementwise. float32: pairs whose barycentrics sit 1e-3 or more from
    an edge, whose t > 1e-3 and |det| > 1e-3."""
    jdt, tdt = DTYPES[prec]
    ro, rd = scene_rays(1000, 5)
    coef = TB.coef_tables(TB.default_params(tdt))[0]
    jcoef = JB.coef_tables(JB.default_params(jdt))[0]
    tcols = [coef[:, k][None, :] for k in range(16)]
    jcols = [jcoef[:, k][None, :] for k in range(16)]
    tm = _tv3(ro, tdt).cross(_tv3(rd, tdt))
    jm = _jv3(ro, jdt).cross(_jv3(rd, jdt))
    col = lambda v: [c.reshape(-1, 1) for c in v]
    got = TB.mt_terms(tcols, col(_tv3(rd, tdt)), col(tm), col(_tv3(ro, tdt)))
    want = JB.mt_terms(jcols, col(_jv3(rd, jdt)), col(jm), col(_jv3(ro, jdt)))
    got_t, want_t = TB.mt_hit_t(*got).numpy(), np.asarray(JB.mt_hit_t(*want))
    det, u_num, v_num, t_num = (np.asarray(w, np.float64) for w in want)
    with np.errstate(divide="ignore", invalid="ignore"):
        u, v, t = u_num / det, v_num / det, t_num / det
    if prec == "f64":
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12, atol=1e-12)
        np.testing.assert_array_equal(np.isfinite(got_t), np.isfinite(want_t))
        good = np.isfinite(want_t)
    else:
        good = (np.abs(det) > 1e-3) & (np.minimum(u, v) > 1e-3) & (u + v < 1 - 1e-3) & (t > 1e-3)
        good |= (np.abs(det) > 1e-3) & ((np.minimum(u, v) < -1e-3) | (u + v > 1 + 1e-3))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy()[good], np.asarray(w)[good], rtol=1e-4, atol=1e-5)
        np.testing.assert_array_equal(np.isfinite(got_t)[good], np.isfinite(want_t)[good])
        good &= np.isfinite(want_t)
    assert good.sum() > 300
    np.testing.assert_allclose(got_t[good], want_t[good], rtol=1e-12 if prec == "f64" else 1e-4)


@pytest.mark.parametrize("prec", ["f64", "f32"])
def test_closest_and_any_hit_match_jax(prec):
    """3,000 seeded rays: t, the face-forward normal, the material and the
    shadow test. float64: every ray equal. float32: a winner may flip to
    the neighbour across an edge; at most 0.5% do (0 of 3,000 here, and 0
    shadow tests differ, when this test was written), and the rest agree to
    rtol 1e-5."""
    jdt, tdt = DTYPES[prec]
    ro, rd = scene_rays(3000, 13)
    jh = JB.closest_hit(JB.default_params(jdt), _jv3(ro, jdt), _jv3(rd, jdt))
    th = TB.closest_hit(TB.default_params(tdt), _tv3(ro, tdt), _tv3(rd, tdt))
    jt, tt = np.asarray(jh.t), th.t.numpy()
    jn = np.stack([np.asarray(c) for c in jh.normal])
    tn = np.stack([c.numpy() for c in th.normal])
    jrgb = np.stack([np.asarray(c) for c in jh.material.rgb])
    trgb = np.stack([c.numpy() for c in th.material.rgb])
    hit = np.isfinite(jt)
    assert 0.3 < hit.mean() < 0.95
    same = (np.isfinite(tt) == hit) & (np.abs(tn - jn).max(axis=0) == 0) & (np.abs(trgb - jrgb).max(axis=0) == 0)
    if prec == "f64":
        assert same.all()
        np.testing.assert_array_equal(tt, jt)
    else:
        assert (~same).mean() <= 5e-3
        both = same & hit
        np.testing.assert_allclose(tt[both], jt[both], rtol=1e-5)
    max_dist = np.random.default_rng(14).uniform(0.5, 8.0, ro.shape[1])
    ja = np.asarray(JB.any_hit(JB.default_params(jdt), _jv3(ro, jdt), _jv3(rd, jdt), jnp.asarray(max_dist, jdt)))
    ta = TB.any_hit(TB.default_params(tdt), _tv3(ro, tdt), _tv3(rd, tdt), torch.tensor(max_dist, dtype=tdt)).numpy()
    assert (ta != ja).mean() <= (0 if prec == "f64" else 1e-3)
    assert 0.1 < ja.mean() < 0.9


def test_blocked_plain_version_equals_one_block(monkeypatch):
    """Blocks of 37 rays (odd, so the last block is short) against all
    rays in one block: the hits and the shadow test bit for bit, the
    vertex gradient to float32 sums in another order."""
    ro, rd = scene_rays(3000, 15)
    p = TB.default_params()
    md = torch.tensor(np.random.default_rng(16).uniform(0.5, 8.0, 3000), dtype=torch.float32)

    def run():
        vx = p.vertices.x.clone().requires_grad_(True)
        q = p._replace(vertices=p.vertices._replace(x=vx))
        h = TB.closest_hit(q, _tv3(ro, torch.float32), _tv3(rd, torch.float32))
        (g,) = torch.autograd.grad((h.t.nan_to_num(posinf=0.0) + h.normal.x).sum(), vx)
        return h, TB.any_hit(q, _tv3(ro, torch.float32), _tv3(rd, torch.float32), md), g

    whole = run()
    monkeypatch.setattr(TB, "BLOCK_PAIRS", 37 * 1152)
    blocked = run()
    assert torch.equal(whole[0].t, blocked[0].t)
    for a, b in zip(whole[0].normal, blocked[0].normal):
        assert torch.equal(a, b)
    assert torch.equal(whole[1], blocked[1])
    # the vertex gradient sums over rays in another order
    scale = float(whole[2].abs().max())
    assert scale > 0
    np.testing.assert_allclose(blocked[2].numpy(), whole[2].numpy(), rtol=0, atol=1e-5 * scale)


def test_cull_admits_every_winner():
    """The per-ray cull of K8, replayed by tools/work.bigmesh_walk: the
    closest hit's winning chunk and a shadow ray's first occluding chunk
    are always admitted, most rays skip some chunks, the closest hit admits
    no more than all nine, and the shadow ray none after its occluder."""
    ro, rd = scene_rays(5000, 17)
    p = TB.default_params()
    tro, trd = _tv3(ro, torch.float32), _tv3(rd, torch.float32)
    mask = bigmesh_walk(p, tro, trd).admitted
    h = TB.closest_hit(p, tro, trd)
    coef = TB.coef_tables(p)[0]
    d, m, o = TB._ray_rows(tro, trd)
    win = TB.pair_ts(coef, d, m, o).argmin(dim=1) // TB.CHUNK
    hit = torch.isfinite(h.t)
    assert mask[hit, win[hit]].all()
    assert mask.shape == (5000, 9) and 0 < mask.float().mean() < 0.8
    md = torch.tensor(np.random.default_rng(18).uniform(0.5, 8.0, 5000), dtype=torch.float32)
    shadow = bigmesh_walk(p, tro, trd, md).admitted
    occ = TB.any_hit(p, tro, trd, md)
    chunk_occ = (TB.pair_ts(coef, d, m, o) < md[:, None]).reshape(5000, 9, -1).any(dim=2)
    first = chunk_occ.float().argmax(dim=1)
    assert shadow[occ, first[occ]].all()
    assert not (shadow & (torch.arange(9)[None, :] > first[:, None]) & occ[:, None]).any()


def _edited_jax_scene():
    s = JB.make_scene(recursion_depth=4)
    p = s.params
    f32 = jnp.float32
    p = p._replace(
        vertices=p.vertices._replace(y=p.vertices.y.at[5].add(0.2)), sky_scale=jnp.asarray(0.7, f32),
        materials=p.materials._replace(roughness=jnp.asarray([0.5, 0.3], f32)),
    )
    lights = s.lights._replace(emission=s.lights.emission._replace(y=jnp.asarray([2.0], f32)))
    return s.replace(params=p, lights=lights)


def test_scene_from_dict_carries_an_edited_bigmesh_scene():
    jax_scene = _edited_jax_scene()
    scene = scene_from_dict(scene_to_dict(jax_scene, "bigmesh"))
    assert scene.closest_hit_fn is TB.closest_hit
    static = {".tri_a", ".tri_b", ".tri_c", ".tri_mat"}
    for section in ("params", "lights", "camera"):
        want = {jax.tree_util.keystr(k): np.asarray(v)
                for k, v in jax.tree_util.tree_flatten_with_path(getattr(jax_scene, section))[0]}
        got = {"." + k: v.numpy() for k, v in getattr(scene, section).named_buffers(remove_duplicate=False)}
        assert sorted(set(got) - static) == sorted(want), section
        for path, w in want.items():
            np.testing.assert_array_equal(got[path], w, err_msg=section + path)
    for name, (got, want) in zip(("coef", "attrT", "aabb"), zip(TB.coef_tables(scene.params.unpack()),
                                                               JB.coef_tables(jax_scene.params))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want, np.float32), err_msg=name)


@pytest.mark.parametrize("with_medium", [False, True])
def test_pack_bigmesh_scene_matches_jax(with_medium):
    jax_scene = _edited_jax_scene()
    scene = scene_from_dict(scene_to_dict(jax_scene, "bigmesh"))
    ref = np.asarray(jax_pack_bigmesh_scene(jax_scene, 64, 48, with_medium=with_medium))
    got = pack_bigmesh_scene(scene, 64, 48, with_medium=with_medium).numpy()
    assert got.shape == ref.shape == (1, 12 + 7 + 15 + (26 if with_medium else 20) * 2)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    sv = pack_bigmesh_scene(scene, 16, 8)
    back, _ = unpack_bigmesh_scene(sv, scene)
    for (name, a), (_, b) in zip(back.named_buffers(), scene.named_buffers()):
        assert torch.equal(a, b), name


def jax_frames() -> dict:
    """The fixtures as JAX renders them today (jax_enable_x64 on)."""
    return {
        FIXTURE: np.asarray(pt.render_frame(JB.make_scene(), jax.random.PRNGKey(3), 64, 48)),
        F64_FIXTURE: np.asarray(pt.render_frame(JB.make_scene(dtype=jnp.float64), jax.random.PRNGKey(7), 64, 32)),
    }


def test_f64_eager_frame_matches_jax_fixture():
    img = T.render_frame(TB.make_scene(dtype=torch.float64), rng.prng_key(7), 64, 32)
    assert img.dtype == torch.float64
    np.testing.assert_allclose(img.numpy(), np.load(F64_FIXTURE), rtol=0, atol=1e-6)


def test_f32_eager_frame_matches_jax_fixture():
    img = T.render_frame(TB.make_scene(), rng.prng_key(3), 64, 48)
    assert img.dtype == torch.float32
    assert_image_close(img, np.load(FIXTURE))


def test_fixtures_are_what_jax_computes():
    for path, frame in jax_frames().items():
        np.testing.assert_allclose(np.load(path), frame, rtol=0, atol=1e-12, err_msg=path)


def test_megakernel_cpu_path_is_the_plain_version_with_autograd():
    scene = TB.make_scene(recursion_depth=2)
    launches = MK.render_frame_megakernel.launches
    img = MK.render_frame_megakernel(scene, rng.prng_key(6), 16, 8)
    assert MK.render_frame_megakernel.launches == launches
    assert torch.equal(img, MK.render_frame_reference(scene, rng.prng_key(6), 16, 8))
    scene.params.vertices.y.requires_grad_(True)
    (g,) = torch.autograd.grad(MK.render_frame_megakernel(scene, rng.prng_key(6), 16, 8).sum(),
                               scene.params.vertices.y)
    assert torch.isfinite(g).all() and float(g.abs().sum()) > 0
    with pytest.raises(NotImplementedError, match="ROADMAP item 12"):
        MK._require_backward("bigmesh")


def test_tables_are_built_once_per_scene():
    """bigmesh_tables keeps a scene's tables while their sources are
    unchanged (one build for many frames), builds them again after an
    in-place edit of a vertex and for a replaced vertex tensor, and then
    returns what coef_tables computes now, coef 16-byte aligned. An edit
    through `.data` is not seen, as its docstring says, until the next
    edit that is."""
    scene = TB.make_scene()
    start = bigmesh_tables.builds
    first = bigmesh_tables(scene)
    for _ in range(3):
        again = bigmesh_tables(scene)
        assert all(a is b for a, b in zip(first, again))
    assert bigmesh_tables.builds == start + 1
    assert first[0].data_ptr() % 16 == 0
    with torch.no_grad():
        scene.params.vertices.y[5] += 0.25
    edited = bigmesh_tables(scene)
    assert bigmesh_tables.builds == start + 2
    fresh = TB.coef_tables(scene.params.unpack())
    assert all(torch.equal(a, b) for a, b in zip(edited, fresh))
    assert not torch.equal(edited[0], first[0])
    scene.params.vertices.x = scene.params.vertices.x.clone()
    bigmesh_tables(scene)
    bigmesh_tables(scene)
    assert bigmesh_tables.builds == start + 3
    scene.params.vertices.z.requires_grad_(True)
    assert bigmesh_tables(scene)[0].requires_grad
    assert bigmesh_tables.builds == start + 4
    kept = bigmesh_tables(scene)
    scene.params.vertices.y.data[7] += 0.5
    assert all(a is b for a, b in zip(bigmesh_tables(scene), kept))
    assert bigmesh_tables.builds == start + 4
    with torch.no_grad():
        scene.params.vertices.y[6] -= 0.125
    caught_up = bigmesh_tables(scene)
    assert bigmesh_tables.builds == start + 5
    assert all(torch.equal(a, b) for a, b in zip(caught_up, TB.coef_tables(scene.params.unpack())))


if __name__ == "__main__":
    jax.config.update("jax_enable_x64", True)
    for path, frame in jax_frames().items():
        np.save(path, frame)
