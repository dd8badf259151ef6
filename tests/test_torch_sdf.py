"""The port's sphere-traced SDF scene (`models/sdf.py`,
`ops/megakernel_sdf.pack_sdf_scene`) held to the JAX package's.

The distance field, its analytic gradient and the march against JAX
elementwise, in float64 and float32 (XLA on the CPU contracts a*b+c into
FMAs, torch does not, so float32 differs by ulps, and a lane whose |sdf|
sits within an ulp of HIT_EPS may stop a step apart); the gradient also at
crafted ties (box faces, edges and corners, the torus ring and axis,
equidistant primitives), where it must take jax.grad's shares. Frames: the
float64 eager frame against JAX's at rtol 1e-7 / atol 1e-9, and the
float32 one against the committed JAX render
tests/golden_torch/sdf_64x48_d4_k3.npy with the image gate of
tests/test_torch_render.py.

The gradient the backward kernel's SDF backend is held to: torch
autograd of the eager `render_frame(detach=True)` with respect to the
sphere radius and the torus major radius, against the committed
`jax.grad` fixture tests/golden_torch/grad_sdf_32x16_d2_k3.npz at the
tolerance of tests/test_megakernel_sdf.py (rtol 5e-3, atol 1e-7); and with
respect to every float leaf of the scene (camera, geometry, smooth_k,
checker, sky, lights, materials), against
tests/golden_torch/grad_sdf_64x48_d4_k3.npz (jax.grad of mean(rgb^2) at
64x48, depth 4, PRNGKey(3)) at tests/test_torch_grad.py's tolerances
(rtol 1e-2 / atol 1e-7 for the geometry and the camera, rtol 5e-3 / atol
1e-8 for the rest). chip_smoke.py phase 14 holds K2 to both files.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pathtracer_tpu as pt
from pathtracer_tpu.integrator.inverse import select_leaves as jax_select_leaves
from pathtracer_tpu.models import sdf as JS
from pathtracer_tpu.ops.megakernel_sdf import pack_sdf_scene as jax_pack_sdf_scene
from pathtracer_tpu.ops.vecmath import V3 as JV3
from pathtracer_tpu.utils.sceneio import scene_to_dict
from pathtracer_tpu_torch.integrator import tracer as T
from pathtracer_tpu_torch.integrator.inverse import named_leaves
from pathtracer_tpu_torch.models import sdf as TS
from pathtracer_tpu_torch.ops import megakernel as MK
from pathtracer_tpu_torch.ops import rng
from pathtracer_tpu_torch.ops.megakernel_sdf import pack_sdf_scene
from pathtracer_tpu_torch.ops.vecmath import V3
from pathtracer_tpu_torch.utils.sceneio import scene_from_dict
from test_torch_kernel_host import one_torch_thread  # noqa: F401
from test_torch_render import assert_image_close

GOLDEN = os.path.join(os.path.dirname(__file__), "golden_torch")
FIXTURE = os.path.join(GOLDEN, "sdf_64x48_d4_k3.npy")
GRAD_FIXTURE = os.path.join(GOLDEN, "grad_sdf_32x16_d2_k3.npz")
GRAD_LEAVES = ("params.sphere_radius", "params.torus_major")
FULL_GRAD_FIXTURE = os.path.join(GOLDEN, "grad_sdf_64x48_d4_k3.npz")
GEOMETRY = ("params.sphere", "params.box", "params.torus", "params.plane", "params.smooth_k", "camera")
DTYPES = {"f64": (jnp.float64, torch.float64), "f32": (jnp.float32, torch.float32)}
pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _params(jdt, tdt, variant: str):
    """The demo params, or a variant on both sides: "smooth" (k = 0.3),
    "twin" (a second sphere equal to the first: every point is a tie)."""
    jp, tp = JS.default_params(jdt), TS.default_params(tdt)
    if variant == "smooth":
        jp, tp = jp._replace(smooth_k=jnp.asarray(0.3, jdt)), tp._replace(smooth_k=torch.tensor(0.3, dtype=tdt))
    elif variant == "twin":
        twin = lambda a, cat: cat([a, a])
        jp = jp._replace(
            sphere_center=JV3(*(twin(c, jnp.concatenate) for c in jp.sphere_center)),
            sphere_radius=twin(jp.sphere_radius, jnp.concatenate),
        )
        tp = tp._replace(
            sphere_center=V3(*(twin(c, torch.cat) for c in tp.sphere_center)),
            sphere_radius=twin(tp.sphere_radius, torch.cat),
        )
    return jp, tp


def _points(dtype) -> np.ndarray:
    """[3, N] points: random ones around the scene, then crafted ties."""
    rs = np.random.default_rng(11)
    pts = [rs.uniform([-3, -1.5, -2], [3, 2.5, 3], (1500, 3))]
    box_c, half = np.array([1.3, -0.25, 0.0]), 0.7
    faces = [(half, 0, 0), (-half, 0.2, 0.1), (half, half, 0), (half, half, half), (-half, half, -half),
             (half + 0.1, half + 0.1, 0), (0.3, 0.3, 0.1), (0.2, 0.2, 0.2), (0, 0, 0), (0, 0.5, 0), (0.9, 0, 0)]
    pts.append(box_c + np.array(faces))
    tor_c, major = np.array([0.0, -0.7, 1.2]), 0.45
    pts.append(tor_c + np.array([(major, 0, 0), (0, 0, major), (0, 0, 0), (0, 0.3, 0), (major, 0.1, 0)]))
    # equidistant: the sphere touches the plane at (-1.3, -1, 0); the
    # sphere's center; the plane itself
    pts.append(np.array([(-1.3, -1.0, 0.0), (-1.3, 0.0, 0.0), (0.5, -1.0, -2.0)]))
    return np.concatenate(pts).T.astype(dtype)


def _jv3(a):
    return JV3(*(jnp.asarray(c) for c in a))


def _tv3(a):
    return V3(*(torch.from_numpy(np.ascontiguousarray(c)) for c in a))


@jax.jit
def _jax_field(jp, x):
    """The JAX package's distances, smooth_min of the first and last,
    scene distance, argmin, jax.grad of the distance (as its sdf_normal
    takes it) and normal at x."""
    jd = JS._primitive_distances(jp, x)
    f = lambda a, b, c: jnp.sum(JS.scene_sdf(jp, JV3(a, b, c)))
    grad = jax.grad(f, argnums=(0, 1, 2))(*x)
    return (jd, JS.smooth_min(jd[0], jd[-1], jp.smooth_k), JS.scene_sdf(jp, x), JS.nearest_primitive(jp, x), grad,
            JS.sdf_normal(jp, x))


@pytest.mark.parametrize("variant", ["demo", "smooth", "twin"])
@pytest.mark.parametrize("prec", ["f64", "f32"])
def test_distance_field_and_normal_match_jax(prec, variant):
    jdt, tdt = DTYPES[prec]
    jp, tp = _params(jdt, tdt, variant)
    pts = _points(np.float64 if prec == "f64" else np.float32)
    tx = _tv3(pts)
    jd, jsmin, jsdf, jidx, jgrad, jnormal = _jax_field(jp, _jv3(pts))
    tol = dict(rtol=1e-12, atol=1e-14) if prec == "f64" else dict(rtol=2e-6, atol=2e-6)
    # the primitives, in material-table order, and smooth_min over them
    td = TS._primitive_distances(tp, tx)
    assert len(td) == jd.shape[0]
    for a, b in zip(jd, td):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **tol)
    np.testing.assert_allclose(TS.smooth_min(td[0], td[-1], tp.smooth_k).numpy(), np.asarray(jsmin), **tol)
    np.testing.assert_allclose(TS.scene_sdf(tp, tx).numpy(), np.asarray(jsdf), **tol)
    np.testing.assert_array_equal(TS.nearest_primitive(tp, tx).numpy(), np.asarray(jidx))
    # the analytic gradient against jax.grad, ties included, and the normal
    for got, want in zip(TS.sdf_gradient(tp, tx), jgrad):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)
    for got, want in zip(TS.sdf_normal(tp, tx), jnormal):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


def test_normal_is_differentiable_in_the_parameters():
    """The normal carries geometry gradients into shading: d(normal)/d(radius,
    box half, torus major, plane normal) against JAX's grad-of-grad normal,
    float64, at points near each surface."""
    pts = _points(np.float64)[:, :300]
    names = ("sphere_radius", "box_half", "torus_major", "plane_normal")
    jp, tp = _params(jnp.float64, torch.float64, "smooth")
    w = np.random.default_rng(2).normal(size=(3, pts.shape[1]))

    def jloss(*leaves):
        n = JS.sdf_normal(jp._replace(**dict(zip(names, leaves))), _jv3(pts))
        return sum(jnp.sum(c * wc) for c, wc in zip(n, w))

    want = jax.jit(jax.grad(jloss, argnums=tuple(range(len(names)))))(*(getattr(jp, k) for k in names))
    leaves = {k: getattr(tp, k) for k in names}
    flat = {k: [c.clone().requires_grad_(True) for c in v] if isinstance(v, tuple) else v.clone().requires_grad_(True)
            for k, v in leaves.items()}
    tp2 = tp._replace(**{k: V3(*v) if isinstance(v, list) else v for k, v in flat.items()})
    n = TS.sdf_normal(tp2, _tv3(pts))
    loss = sum((c * torch.from_numpy(wc)).sum() for c, wc in zip(n, w))
    loss.backward()
    for k, ref in zip(names, want):
        got = [c.grad for c in flat[k]] if isinstance(flat[k], list) else [flat[k].grad]
        ref = list(ref) if isinstance(ref, tuple) else [ref]
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-9, atol=1e-12, err_msg=k)


def _rays(n: int, dtype):
    """Camera-like rays toward the scene, then grazing ones: skimming the
    plane, and tangent to the sphere."""
    rs = np.random.default_rng(4)
    ro = np.tile([[0.0, 0.0, 3.0]], (n, 1)) + rs.uniform(-0.2, 0.2, (n, 3))
    rd = rs.uniform([-0.8, -0.6, -1.0], [0.8, 0.5, -1.0], (n, 3))
    k = n // 4
    ro[:k] = rs.uniform([-3, -1.0, -2], [3, -1.0, 2], (k, 3))
    ro[:k, 1] += rs.uniform(1e-3, 2e-2, k)
    rd[:k] = np.stack([rs.uniform(-1, 1, k), rs.uniform(-3e-3, 3e-3, k), rs.uniform(-1, 1, k)], 1)
    u = rs.normal(size=(k, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    tangent = np.cross(u, rs.normal(size=(k, 3)))
    touch = np.array([-1.3, 0.0, 0.0]) + u * (1.0 + rs.uniform(-2e-3, 2e-3, (k, 1)))
    ro[k:2 * k] = touch - tangent * 2.0
    rd[k:2 * k] = tangent
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return ro.T.astype(dtype), rd.T.astype(dtype)


@pytest.mark.parametrize("prec", ["f64", "f32"])
def test_sphere_trace_matches_jax(prec):
    jdt, tdt = DTYPES[prec]
    ro, rd = _rays(4000, np.float64 if prec == "f64" else np.float32)
    jt, jh = jax.jit(JS.sphere_trace)(JS.default_params(jdt), _jv3(ro), _jv3(rd))
    tt, th = TS.sphere_trace(TS.default_params(tdt), _tv3(ro), _tv3(rd))
    jt, jh, tt, th = np.asarray(jt), np.asarray(jh), tt.numpy(), th.numpy()
    assert 0.2 < jh.mean() < 0.9
    if prec == "f64":
        np.testing.assert_array_equal(th, jh)
        np.testing.assert_allclose(tt, jt, rtol=1e-9)
    else:
        assert (th == jh).mean() >= 0.999
        both = th & jh
        np.testing.assert_allclose(tt[both], jt[both], rtol=0, atol=2e-3)


@pytest.mark.parametrize("with_medium", [False, True])
def test_pack_sdf_scene_matches_jax(with_medium):
    jax_scene = _edited_jax_scene()
    scene = scene_from_dict(scene_to_dict(jax_scene, "sdf"))
    ref = np.asarray(jax_pack_sdf_scene(jax_scene, 64, 48, with_medium=with_medium))
    got = pack_sdf_scene(scene, 64, 48, with_medium=with_medium).numpy()
    assert got.shape == ref.shape == (1, 45 + 15 + (26 if with_medium else 20) * 4)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)  # the camera basis may differ by ulps
    assert pack_sdf_scene(TS.make_scene(), 64, 48).shape == (1, 140)


def _edited_jax_scene():
    s = JS.make_scene(recursion_depth=4)
    f32 = jnp.float32
    p = s.params._replace(
        sphere_radius=jnp.asarray([0.8], f32),
        torus_major=jnp.asarray([0.5], f32),
        box_half=JV3(jnp.asarray([0.6], f32), jnp.asarray([0.7], f32), jnp.asarray([0.5], f32)),
        smooth_k=jnp.asarray(0.2, f32),
        checker_scale=jnp.asarray(2.0, f32),
        materials=s.params.materials._replace(roughness=jnp.asarray([0.2, 0.3, 0.5, 0.9], f32)),
    )
    lights = s.lights._replace(emission=s.lights.emission._replace(x=jnp.asarray([4.0], f32)))
    return s.replace(params=p, lights=lights)


def test_scene_from_dict_carries_an_edited_sdf_scene():
    """Every leaf crosses, and the port renders the edited scene as JAX does
    (64x48, depth 4, PRNGKey(5))."""
    jax_scene = _edited_jax_scene()
    scene = scene_from_dict(scene_to_dict(jax_scene, "sdf"))
    assert scene.closest_hit_fn is TS.closest_hit and scene.recursion_depth == 4
    for section in ("params", "lights", "camera"):
        want = {jax.tree_util.keystr(k): np.asarray(v)
                for k, v in jax.tree_util.tree_flatten_with_path(getattr(jax_scene, section))[0]}
        got = {"." + k: v.numpy() for k, v in getattr(scene, section).named_buffers(remove_duplicate=False)}
        assert sorted(got) == sorted(want), section
        for path, w in want.items():
            np.testing.assert_array_equal(got[path], w, err_msg=section + path)
    ref = pt.render_frame(jax_scene, jax.random.PRNGKey(5), 64, 48)
    assert_image_close(T.render_frame(scene, rng.prng_key(5), 64, 48), ref)


@pytest.mark.parametrize("quirks", ["verbatim", "fixed"])
def test_f64_eager_frame_matches_jax(quirks):
    jq, tq = (pt.VERBATIM, T.VERBATIM) if quirks == "verbatim" else (pt.FIXED, T.FIXED)
    ref = pt.render_frame(JS.make_scene(dtype=jnp.float64), jax.random.PRNGKey(9), 32, 16, quirks=jq)
    img = T.render_frame(TS.make_scene(dtype=torch.float64), rng.prng_key(9), 32, 16, quirks=tq)
    assert img.dtype == torch.float64
    np.testing.assert_allclose(img.numpy(), np.asarray(ref), rtol=1e-7, atol=1e-9)


@pytest.fixture(scope="module")
def jax_64x48_k3():
    return np.asarray(pt.render_frame(JS.make_scene(), jax.random.PRNGKey(3), 64, 48))


def test_f32_eager_frame_matches_jax_fixture():
    img = T.render_frame(TS.make_scene(), rng.prng_key(3), 64, 48)
    assert img.dtype == torch.float32
    assert_image_close(img, np.load(FIXTURE))


def test_fixture_is_current(jax_64x48_k3):
    # chip_smoke.py holds K1's SDF backend to this file on the card, where
    # JAX is absent; it must stay what JAX renders today.
    np.testing.assert_allclose(np.load(FIXTURE), jax_64x48_k3, rtol=0, atol=1e-6)


def test_megakernel_cpu_path_is_the_plain_version():
    scene = TS.make_scene(recursion_depth=2)
    launches = MK.render_frame_megakernel.launches
    img = MK.render_frame_megakernel(scene, rng.prng_key(6), 16, 8)
    assert MK.render_frame_megakernel.launches == launches  # CPU: no kernel launch
    assert torch.equal(img, MK.render_frame_reference(scene, rng.prng_key(6), 16, 8))
    # a CPU SDF scene keeps eager autograd
    scene.params.sphere_radius.requires_grad_(True)
    (g,) = torch.autograd.grad(MK.render_frame_megakernel(scene, rng.prng_key(6), 16, 8).sum(),
                               scene.params.sphere_radius)
    assert torch.isfinite(g).all() and float(g.abs()) > 0


def test_newton_gradient_is_finite_on_a_runaway_miss():
    """A bounce of the 1080p frame of PRNGKey(45) starts inside the union
    and its march runs away to t* ~ -3e34, a miss. The field at t*
    overflows; JAX's Newton step reads it there and jax.grad is NaN (0 *
    inf in smooth_min's unused branch), which K2, differentiating hits
    only, is not. The plain version reads the field at t = 0 on a miss, so
    its gradient is the miss's 0."""
    p = TS.default_params()
    radius = p.sphere_radius.clone().requires_grad_(True)
    ro = V3(*(torch.tensor([v]) for v in (1.6954487562179565, -0.9954045414924622, 0.7076557278633118)))
    rd = V3(*(torch.tensor([v]) for v in (-0.2268698364496231, 0.9211181402206421, -0.31634077429771423)))
    t_star, _ = TS.march(TS._detached(p), ro, rd)
    assert float(t_star) < -1e30
    h = TS.closest_hit(p._replace(sphere_radius=radius), ro, rd)
    assert not bool(torch.isfinite(h.t).any())
    loss = torch.where(torch.isfinite(h.t), h.t, 0.0).sum() + sum(c.sum() for c in h.normal)
    (g,) = torch.autograd.grad(loss, radius)
    assert torch.equal(g, torch.zeros(1))


def _port_grads(w: int, h: int, depth: int, key) -> dict:
    scene = TS.make_scene(recursion_depth=depth)
    leaves = dict(scene.named_buffers())
    for n in GRAD_LEAVES:
        leaves[n].requires_grad_(True)
    img = T.render_frame(scene, key, w, h, detach=True)
    grads = torch.autograd.grad((img[..., :3] ** 2).mean(), [leaves[n] for n in GRAD_LEAVES])
    return {n: g.numpy() for n, g in zip(GRAD_LEAVES, grads)}


def test_eager_grad_matches_jax_fixture():
    got = _port_grads(32, 16, 2, rng.prng_key(3))
    with np.load(GRAD_FIXTURE) as want:
        assert sorted(want.files) == sorted(GRAD_LEAVES)
        for n in GRAD_LEAVES:
            np.testing.assert_allclose(got[n], want[n], rtol=5e-3, atol=1e-7, err_msg=n)
            assert np.abs(want[n]).max() > 1e-4


def jax_sdf_grads() -> dict:
    """jax.grad of mean(img[..., :3]**2) of JAX's render_frame(detach=True,
    remat=True) on the SDF scene (float32, depth 2, 32x16, PRNGKey(3)) with
    respect to the sphere radius and the torus major radius."""
    s = JS.make_scene(dtype=jnp.float32, recursion_depth=2)

    def loss(rad, major):
        sc = s.replace(params=s.params._replace(sphere_radius=rad, torus_major=major))
        img = pt.render_frame(sc, jax.random.PRNGKey(3), 32, 16, detach=True, remat=True)
        return jnp.mean(img[..., :3] ** 2)

    g = jax.grad(loss, argnums=(0, 1))(s.params.sphere_radius, s.params.torus_major)
    return {n: np.asarray(v) for n, v in zip(GRAD_LEAVES, g)}


@pytest.mark.slow
def test_grad_fixture_is_what_jax_computes():
    """About a minute on a CPU. Regenerate the fixture with
    `JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_sdf.py` from the
    repository root (it writes the three SDF fixtures, under
    jax_enable_x64 as the tests run)."""
    want = jax_sdf_grads()
    with np.load(GRAD_FIXTURE) as got:
        for n in GRAD_LEAVES:
            np.testing.assert_allclose(got[n], want[n], rtol=1e-5, atol=1e-9, err_msg=n)


def full_grad_close(got, want, name) -> bool:
    """tests/test_torch_grad.py's tolerances, the geometry's for every
    primitive, the plane and smooth_k."""
    rtol, atol = (1e-2, 1e-7) if name.startswith(GEOMETRY) else (5e-3, 1e-8)
    return bool(np.all(np.abs(np.asarray(got, np.float64) - want) <= atol + rtol * np.abs(want)))


def jax_sdf_full_grads() -> dict:
    """jax.grad of mean(img[..., :3]**2) of JAX's render_frame(detach=True,
    remat=True) on the SDF scene (float32, depth 4, 64x48, PRNGKey(3)) with
    respect to every float leaf, keyed by its dotted path."""
    train, rebuild, names = jax_select_leaves(JS.make_scene(dtype=jnp.float32, recursion_depth=4), ("",))

    def loss(tv):
        img = pt.render_frame(rebuild(tv), jax.random.PRNGKey(3), 64, 48, detach=True, remat=True)
        return jnp.mean(img[..., :3] ** 2)

    return {n: np.asarray(g) for n, g in zip(names, jax.grad(loss)(train))}


def test_eager_grad_of_every_leaf_matches_jax_fixture():
    scene = TS.make_scene()
    leaves = dict(named_leaves(scene))
    with np.load(FULL_GRAD_FIXTURE) as data:
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
    # the geometry carries gradient (the Newton reattachment and the normal)
    for n in ("params.sphere_radius", "params.torus_major", "params.box_half.y", "params.plane_normal.x"):
        assert np.abs(want[n]).max() > 1e-3, n


@pytest.mark.slow
def test_full_grad_fixture_is_what_jax_computes():
    """About 80 seconds on a CPU (the 64x48 depth-4 gradient of the march's
    jit). Regenerate as test_grad_fixture_is_what_jax_computes says."""
    want = jax_sdf_full_grads()
    with np.load(FULL_GRAD_FIXTURE) as got:
        assert sorted(got.files) == sorted(want)
        for n in want:
            np.testing.assert_allclose(got[n], want[n], rtol=1e-5, atol=1e-9, err_msg=n)


if __name__ == "__main__":
    jax.config.update("jax_enable_x64", True)
    np.save(FIXTURE, np.asarray(pt.render_frame(JS.make_scene(), jax.random.PRNGKey(3), 64, 48)))
    np.savez(GRAD_FIXTURE, **jax_sdf_grads())
    np.savez(FULL_GRAD_FIXTURE, **jax_sdf_full_grads())
