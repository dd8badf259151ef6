"""The port's renders held to the reference: the float64 eager integrator
to the scalar CPU oracle's goldens, the float32 eager integrator to JAX
`render_frame`, and `ops/megakernel` on the CPU (its plain version) to
JAX's Pallas kernel in interpret mode. Both sides draw the same threefry
numbers, so the images agree pixel for pixel up to float rounding; a rare
knife-edge pixel may take the other branch, hence the quantile bound."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pathtracer_tpu as pt
from oracle_cache import cached_render
from pathtracer_tpu.oracle import cpu_oracle as O
from pathtracer_tpu.ops.megakernel import render_frame_pallas
from pathtracer_tpu_torch.integrator import tracer as T
from pathtracer_tpu_torch.models.analytical import make_scene
from pathtracer_tpu_torch.models.scene import SurfaceHit
from pathtracer_tpu_torch.ops import megakernel as MK
from pathtracer_tpu_torch.ops import rng

FIXTURE = os.path.join(os.path.dirname(__file__), "golden_torch", "analytical_64x48_d4_k3.npy")


def assert_image_close(img, ref):
    """quantile(|diff|, 0.999) < 1e-4, mean < 1e-5, all finite."""
    img, ref = np.asarray(img, np.float64), np.asarray(ref, np.float64)
    assert img.shape == ref.shape
    assert np.isfinite(img).all()
    diff = np.abs(img - ref)
    assert np.quantile(diff, 0.999) < 1e-4, np.quantile(diff, 0.999)
    assert diff.mean() < 1e-5, diff.mean()


@pytest.mark.parametrize(
    "quirks,depth,seed",
    [(pt.VERBATIM, 4, 0), (pt.FIXED, 4, 0), (pt.VERBATIM, 8, 3)],
    ids=["verbatim", "fixed", "depth8"],
)
def test_f64_eager_matches_oracle(quirks, depth, seed):
    # The configurations of tests/test_oracle_parity.py: same scene, key
    # and uniforms, so cached_render hits the committed goldens.
    w, h = 24, 16
    jax_scene = pt.make_analytical_scene(dtype=jnp.float64, recursion_depth=depth)
    cam_u, bounce_u = (np.array(a, np.float64) for a in pt.draw_uniforms(jax.random.PRNGKey(seed), w * h, depth, jnp.float64))
    oracle = cached_render(
        O.OracleScene(jax_scene.params, jax_scene.lights, jax_scene.camera, recursion_depth=depth),
        w, h, cam_u, bounce_u,
        stale_emitter_gate=quirks.stale_emitter_gate, primary_mis=quirks.primary_mis,
    )
    tq = T.Quirks(quirks.stale_emitter_gate, quirks.primary_mis)
    scene = make_scene(dtype=torch.float64, recursion_depth=depth)
    img = T.render_frame(
        scene, None, w, h, quirks=tq, uniforms=(torch.from_numpy(cam_u), torch.from_numpy(bounce_u))
    )
    np.testing.assert_allclose(img.numpy(), oracle, rtol=1e-9, atol=1e-11)
    # the port's own float64 stream is JAX's, bit for bit
    own = T.render_frame(scene, rng.prng_key(seed), w, h, quirks=tq)
    np.testing.assert_array_equal(own.numpy(), img.numpy())


@pytest.fixture(scope="module")
def jax_64x48_k3():
    """JAX render_frame at the fixture's configuration (shared by two tests)."""
    return np.asarray(pt.render_frame(pt.make_analytical_scene(), jax.random.PRNGKey(3), 64, 48))


def test_f32_eager_matches_jax(jax_64x48_k3):
    img = T.render_frame(make_scene(), rng.prng_key(3), 64, 48)
    assert img.dtype == torch.float32
    assert_image_close(img, jax_64x48_k3)


@pytest.mark.parametrize("w,h,spp,seed", [(64, 48, 2, 4), (150, 37, 1, 9)], ids=["spp2", "edge"])
def test_f32_eager_matches_jax_sizes(w, h, spp, seed):
    ref = pt.render_frame(pt.make_analytical_scene(), jax.random.PRNGKey(seed), w, h, spp=spp)
    img = T.render_frame(make_scene(), rng.prng_key(seed), w, h, spp=spp)
    assert_image_close(img, ref)


def test_fixture_is_current(jax_64x48_k3):
    # chip_smoke.py holds the CUDA kernel to this file on the card, where
    # JAX is absent; it must stay what JAX renders today.
    np.testing.assert_allclose(np.load(FIXTURE), jax_64x48_k3, rtol=0, atol=1e-6)


def test_megakernel_cpu_path_matches_pallas():
    w, h, depth = 32, 24, 2
    key = jax.random.PRNGKey(21)
    ref = render_frame_pallas(
        pt.make_analytical_scene(recursion_depth=depth), key, w, h,
        uniforms="hbm", interpret=True, tile_rows=8,
    )
    scene = make_scene(recursion_depth=depth)
    launches = MK.render_frame_megakernel.launches
    img = MK.render_frame_megakernel(scene, rng.prng_key(21), w, h)
    assert MK.render_frame_megakernel.launches == launches  # CPU: no kernel launch
    plain = MK.render_frame_reference(scene, rng.prng_key(21), w, h)
    assert torch.equal(img, plain)
    assert_image_close(img, ref)
    assert_image_close(plain, ref)


def test_accumulate_matches_jax():
    rs = np.random.default_rng(0)
    frames = rs.random((4, 6, 5, 4))
    jbuf, jn = jnp.zeros((6, 5, 4), jnp.float64), jnp.asarray(0.0)
    tbuf, tn = torch.zeros((6, 5, 4), dtype=torch.float64), torch.tensor(0.0, dtype=torch.float64)
    for f in frames:
        jbuf, jn = pt.accumulate(jbuf, jnp.asarray(f), jn)
        tbuf, tn = T.accumulate(tbuf, torch.from_numpy(f), tn)
    np.testing.assert_allclose(tbuf.numpy(), np.asarray(jbuf), rtol=1e-12)
    np.testing.assert_allclose(tbuf.numpy(), frames.mean(axis=0), rtol=1e-12)
    assert float(tn) == float(jn) == 4.0


def test_megakernel_refuses_what_it_does_not_take():
    key = rng.prng_key(0)
    scene = make_scene()
    scene.params.sphere_radius.requires_grad_(True)
    with pytest.raises(ValueError, match="forward only"):
        MK.render_frame_megakernel(scene, key, 8, 8)

    scene = make_scene()
    MK.render_frame_megakernel(scene, key, 8, 8)
    scene.params.materials.medium.medium_type = torch.tensor([0, 2, 0], dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="media"):
        MK.render_frame_megakernel(scene, key, 8, 8)
    # an in-place edit after a passing frame is seen too
    scene = make_scene()
    MK.render_frame_megakernel(scene, key, 8, 8)
    scene.params.materials.medium.medium_type[1] = 1
    with pytest.raises(NotImplementedError, match="media"):
        MK.render_frame_megakernel(scene, key, 8, 8)

    hook = lambda p, hit, ro, rd: hit.material  # noqa: E731
    with pytest.raises(NotImplementedError, match="procedural"):
        MK.render_frame_megakernel(make_scene().replace(procedural_fn=hook), key, 8, 8)

    other = lambda p, ro, rd: SurfaceHit(None, None, None)  # noqa: E731
    with pytest.raises(NotImplementedError, match="analytical"):
        MK.render_frame_megakernel(make_scene().replace(closest_hit_fn=other), key, 8, 8)

    with pytest.raises(NotImplementedError):
        T.render_frame(make_scene(), key, 8, 8, estimator="nee")
