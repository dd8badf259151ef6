"""The port's threefry stream (pathtracer_tpu_torch.ops.rng) is bit-equal
to jax.random under JAX's partitionable threefry layout."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pathtracer_tpu as pt
from pathtracer_tpu_torch.integrator import tracer as T
from pathtracer_tpu_torch.ops import rng
from pathtracer_tpu_torch.ops.megakernel import sample_keys


def _u32(a) -> np.ndarray:
    return np.asarray(a).astype(np.uint64)


def test_jax_threefry_is_partitionable():
    # The port reproduces the partitionable layout only; a change of JAX's
    # default must fail here instead of drifting silently.
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", [0, 3, 7, 123456789, 2**40 + 5, -3])
def test_prng_key(seed):
    np.testing.assert_array_equal(_u32(jax.random.PRNGKey(seed)), rng.prng_key(seed).numpy())


@pytest.mark.parametrize("seed,n", [(0, 2), (7, 5), (42, 1000), (2**40 + 5, 3)])
def test_split(seed, n):
    ref = _u32(jax.random.split(jax.random.PRNGKey(seed), n))
    np.testing.assert_array_equal(ref, rng.split(rng.prng_key(seed), n).numpy())


@pytest.mark.parametrize("shape", [(1,), (7, 3), (1000, 2), (4, 257, 8)])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_uniform(shape, dtype):
    key = jax.random.PRNGKey(11)
    ref = np.asarray(jax.random.uniform(key, shape, getattr(jnp, dtype)))
    got = rng.uniform(rng.prng_key(11), shape, getattr(torch, dtype)).numpy()
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(ref, got)


def test_uniform_f32_flat_counter():
    # The megakernel's view: flat index i of any draw shape.
    key = jax.random.PRNGKey(5)
    ref = np.asarray(jax.random.uniform(key, (3, 50, 8), jnp.float32)).reshape(-1)
    np.testing.assert_array_equal(ref, rng.uniform_f32(rng.prng_key(5), 1200).numpy())


@pytest.mark.parametrize("depth", [1, 4, 8])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_draw_uniforms_bit_equal(depth, dtype):
    key = jax.random.PRNGKey(7)
    cam, bounce = pt.draw_uniforms(key, 1000, depth, getattr(jnp, dtype))
    tcam, tbounce = T.draw_uniforms(rng.prng_key(7), 1000, depth, getattr(torch, dtype))
    np.testing.assert_array_equal(np.asarray(cam), tcam.numpy())
    np.testing.assert_array_equal(np.asarray(bounce), tbounce.numpy())


@pytest.mark.parametrize("spp", [1, 2, 4])
def test_spp_sample_keys(spp):
    # render_frame: sample s uses split(key, spp)[s] (the key itself at
    # spp 1), then draw_uniforms splits that into (kc, kb).
    key = jax.random.PRNGKey(9)
    subkeys = [key] if spp == 1 else list(jax.random.split(key, spp))
    ref = np.stack([_u32(jax.random.split(k)).reshape(-1) for k in subkeys])
    np.testing.assert_array_equal(ref, sample_keys(rng.prng_key(9), spp).numpy())
