"""The march-step counter K6 (`ops/megakernel_sdf.measure_march_steps`):
its plain version held to the JAX package's Pallas kernel in interpret
mode.

The JAX kernel reports, per flat tile of 8 x 128 lanes, the trips the whole
tile marched: its slowest lane's count rounded up to a block of
MARCH_BLOCK = 12 steps (the tile checks for convergence once a block),
capped at MAX_STEPS. The port counts per pixel; reduced the same way, the
two agree tile for tile, for the primary march and the NEE shadow march.
"""

import numpy as np
import pytest
import torch

from pathtracer_tpu.models.sdf import make_scene as make_jax_sdf_scene
from pathtracer_tpu.ops.megakernel_sdf import measure_march_steps as jax_measure_march_steps
from pathtracer_tpu_torch.models import sdf
from pathtracer_tpu_torch.ops import megakernel_sdf as MS
from test_torch_kernel_host import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

W, H = 128, 32


def flat_tiles(counts: torch.Tensor, tile: int = 8 * 128) -> np.ndarray:
    """Per-pixel trips -> the JAX kernel's per-tile trips over flat tiles of
    `tile` consecutive pixels."""
    worst = counts.reshape(-1, tile).amax(dim=1).numpy()
    return np.minimum(sdf.MARCH_BLOCK * -(-worst // sdf.MARCH_BLOCK), sdf.MAX_STEPS)


def test_plain_march_steps_match_jax_tiles():
    ref = jax_measure_march_steps(make_jax_sdf_scene(recursion_depth=2), W, H, tile_rows=8, tiling="flat",
                                  interpret=True)
    launches = MS.measure_march_steps.launches
    got = MS.measure_march_steps(sdf.make_scene(recursion_depth=2), W, H)
    assert MS.measure_march_steps.launches == launches  # CPU: the plain version
    np.testing.assert_array_equal(flat_tiles(got["steps"]), ref["steps_per_tile"])
    np.testing.assert_array_equal(flat_tiles(got["shadow_steps"]), ref["shadow_steps_per_tile"])
    for name in ("", "shadow_"):
        c, w = got[f"{name}steps"], got[f"{name}warp_steps"]
        assert c.shape == (H, W) and c.dtype == torch.int32
        assert 1 <= int(c.min()) and int(c.max()) <= sdf.MAX_STEPS
        assert w.shape == (W * H // 32,)
        np.testing.assert_array_equal(w.numpy(), c.reshape(-1, 32).amax(dim=1).numpy())
        assert got[f"{name}warp_max_steps"] == got[f"{name}max_steps"] == int(c.max())
        assert got[f"{name}mean_steps"] <= got[f"{name}warp_mean_steps"] <= got[f"{name}warp_max_steps"]


def test_warp_max_of_a_short_last_warp():
    counts = torch.arange(1, 71, dtype=torch.int32).reshape(7, 10)
    np.testing.assert_array_equal(MS.warp_max(counts).numpy(), [32, 64, 70])
