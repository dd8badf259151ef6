"""The port's eager gradients held to `jax.grad`.

Torch autograd through `integrator/tracer.render_frame(detach=True)` is the
detached-sampling estimator and the plain version of the backward
megakernel K2; the JAX side is `jax.grad` of `render_frame(detach=True,
remat=True)` on the same threefry numbers. Tolerances as
tests/test_megakernel_grad.py: rtol 5e-3 / atol 1e-8 for material and
light leaves, rtol 1e-2 / atol 1e-7 for geometry and camera.

The committed fixture tests/golden_torch/grad_analytical_64x48_d4_k3.npz
holds jax.grad of mean(img[..., :3]**2) with respect to every float leaf
of the demo scene (keyed by the leaf's dotted path), at PRNGKey(3),
64x48, depth 4, float32; the card check (chip_smoke.py phase 7) holds K2
to it. Regenerate it with `select_leaves(scene, ("",))` of
pathtracer_tpu.integrator.inverse and that loss, under jax_enable_x64.
tests/golden_torch/grad_analytical_32x16_d2_k7.npz holds the small case
(`jax_small_grads`; regenerate with `JAX_PLATFORMS=cpu PYTHONPATH=. python
tests/test_torch_grad.py`). The checks that JAX still computes both files
are marked `slow` (20-50 s of JAX compiles).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pathtracer_tpu as pt
from pathtracer_tpu.integrator.inverse import select_leaves as jax_select_leaves
from pathtracer_tpu_torch.integrator.inverse import named_leaves
from pathtracer_tpu_torch.integrator.tracer import render_frame
from pathtracer_tpu_torch.models.analytical import make_scene
from pathtracer_tpu_torch.ops import rng
from pathtracer_tpu_torch.ops.vecmath import clip, maximum, minimum
from test_torch_kernel_host import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

FIXTURE = os.path.join(os.path.dirname(__file__), "golden_torch", "grad_analytical_64x48_d4_k3.npz")
MATERIAL_LIGHT = dict(rtol=5e-3, atol=1e-8)
GEOMETRY_CAMERA = dict(rtol=1e-2, atol=1e-7)


@pytest.mark.parametrize("seed,data", [(0, 17), (5, 29), (2**40 + 3, 2**31 + 7), (7, 2**32 - 1)])
def test_fold_in_matches_jax(seed, data):
    want = np.asarray(jax.random.fold_in(jax.random.PRNGKey(seed), data)).astype(np.int64)
    np.testing.assert_array_equal(rng.fold_in(rng.prng_key(seed), data).numpy(), want)


def test_tie_gradients_match_jax():
    """maximum/minimum/clip send half the gradient to each side of a tie,
    as jnp.maximum/jnp.clip do (torch.clamp would send all of it)."""
    x = np.array([0.0, 0.5, 1.0, -0.2, 1.3, 0.01])
    jg = jax.grad(lambda v: jnp.sum(jnp.clip(v, 0.0, 1.0) * 2.0 + jnp.maximum(v, 0.01) + jnp.minimum(v, 0.5)))(x)
    t = torch.tensor(x, requires_grad=True)
    (clip(t, 0.0, 1.0) * 2.0 + maximum(t, 0.01) + minimum(t, 0.5)).sum().backward()
    np.testing.assert_array_equal(t.grad.numpy(), np.asarray(jg))


def _port_grads(scene, key, w, h, names):
    """d mean(img[..., :3]**2) / d(named leaves) through the eager frame."""
    leaves = dict(named_leaves(scene))
    for n in names:
        leaves[n].requires_grad_(True)
    img = render_frame(scene, key, w, h, detach=True)
    grads = torch.autograd.grad((img[..., :3] ** 2).mean(), [leaves[n] for n in names], allow_unused=True)
    return {n: np.zeros(leaves[n].shape) if g is None else g.numpy() for n, g in zip(names, grads)}


SMALL_FIXTURE = os.path.join(os.path.dirname(__file__), "golden_torch", "grad_analytical_32x16_d2_k7.npz")
SMALL_LEAVES = [f"lights.emission.{c}" for c in "xyz"] + [f"params.materials.rgb.{c}" for c in "xyz"] + [
    "params.sphere_center.x", "camera.origin.z"]


def jax_small_grads() -> dict:
    """jax.grad of mean(img[..., :3]**2) at 32x16, depth 2, PRNGKey(7) with
    respect to the light emission, the material rgb, the sphere centers' x
    and the camera origin's z."""
    w, h = 32, 16
    js = pt.make_analytical_scene(dtype=jnp.float32, recursion_depth=2)

    def loss(em, rgb, cx, cz):
        s = js.replace(
            lights=js.lights._replace(emission=em),
            params=js.params._replace(
                materials=js.params.materials._replace(rgb=rgb),
                sphere_center=js.params.sphere_center._replace(x=cx),
            ),
            camera=js.camera._replace(origin=js.camera.origin._replace(z=cz)),
        )
        img = pt.render_frame(s, jax.random.PRNGKey(7), w, h, spp=1, detach=True, remat=True)
        return jnp.mean(img[..., :3] ** 2)

    em, rgb, cx, cz = jax.grad(loss, argnums=(0, 1, 2, 3))(
        js.lights.emission, js.params.materials.rgb, js.params.sphere_center.x, js.camera.origin.z
    )
    return {name: np.asarray(g) for name, g in zip(SMALL_LEAVES, [em.x, em.y, em.z, rgb.x, rgb.y, rgb.z, cx, cz])}


def test_eager_grad_matches_jax():
    """Light emission, material rgb, a sphere center and the camera origin:
    32x16, depth 2, PRNGKey(7), against jax.grad as committed in
    tests/golden_torch/grad_analytical_32x16_d2_k7.npz."""
    got = _port_grads(make_scene(recursion_depth=2), rng.prng_key(7), 32, 16, SMALL_LEAVES)
    with np.load(SMALL_FIXTURE) as want:
        assert sorted(want.files) == sorted(SMALL_LEAVES)
        for name in SMALL_LEAVES:
            tol = GEOMETRY_CAMERA if name.startswith(("params.sphere", "camera")) else MATERIAL_LIGHT
            np.testing.assert_allclose(got[name], want[name], err_msg=name, **tol)
    assert max(np.abs(got[n]).max() for n in SMALL_LEAVES) > 1e-6


@pytest.mark.slow
def test_small_grad_fixture_is_what_jax_computes():
    with np.load(SMALL_FIXTURE) as want:
        for name, g in jax_small_grads().items():
            np.testing.assert_allclose(want[name], g, rtol=1e-5, atol=1e-9, err_msg=name)


@pytest.fixture(scope="module")
def fixture_grads():
    with np.load(FIXTURE) as data:
        return {k: data[k] for k in data.files}


@pytest.mark.slow
def test_grad_fixture_is_what_jax_computes(fixture_grads):
    scene = pt.make_analytical_scene(dtype=jnp.float32, recursion_depth=4)
    train, rebuild, names = jax_select_leaves(scene, ("",))

    def loss(tv):
        img = pt.render_frame(rebuild(tv), jax.random.PRNGKey(3), 64, 48, detach=True, remat=True)
        return jnp.mean(img[..., :3] ** 2)

    grads = jax.grad(loss)(train)
    assert sorted(names) == sorted(fixture_grads)
    for name, g in zip(names, grads):
        np.testing.assert_allclose(fixture_grads[name], np.asarray(g), rtol=1e-5, atol=1e-9, err_msg=name)


# The leaves the tolerances above were set for, and the trainable ones of
# the inverse-rendering demo.
FIXTURE_LEAVES = (
    [f"lights.emission.{c}" for c in "xyz"] + [f"params.materials.rgb.{c}" for c in "xyz"]
    + ["params.materials.roughness", "params.sphere_center.x", "camera.origin.z"]
)


def test_eager_grad_matches_fixture(fixture_grads):
    got = _port_grads(make_scene(), rng.prng_key(3), 64, 48, FIXTURE_LEAVES)
    for name in FIXTURE_LEAVES:
        tol = GEOMETRY_CAMERA if name.startswith(("params.sphere", "camera")) else MATERIAL_LIGHT
        np.testing.assert_allclose(got[name], fixture_grads[name], err_msg=name, **tol)


if __name__ == "__main__":
    jax.config.update("jax_enable_x64", True)
    np.savez(SMALL_FIXTURE, **jax_small_grads())
