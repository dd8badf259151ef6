"""The in-kernel uniform stream's witness K4
(`ops/megakernel.debug_uniform_stream`): its plain version held to JAX's
threefry draw, the statistics `tests/test_rng.py` runs on the TPU
kernel's stream, the per-element code of `csrc/uniform_stream.cu` built
for the host, and the validation tool on the CPU.

The port's kernels draw threefry at JAX's counters, so the stream is
JAX's `draw_uniforms(PRNGKey(seed), N, depth)` rearranged to the TPU
kernel's output layout [tiles, draws, tile_rows, 128], and is cheap to
draw here: no fixture. The card's K4 is held bit for bit to the plain
version in tests/test_torch_kernel_cuda.py and chip_smoke.py phase 26.
Budget: ~10 s for the module on one torch thread.
"""

import ctypes
import json

import jax
import numpy as np
import pytest
import torch

from pathtracer_tpu.integrator.tracer import draw_uniforms as jax_draw_uniforms
from pathtracer_tpu_torch.ops import megakernel as MK
from pathtracer_tpu_torch.ops import rng
from pathtracer_tpu_torch.tools import validate_rng
from test_torch_kernel_host import PRELUDE, build_shim, launch_keys, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def jax_stream(seed: int, num_tiles: int, n_uniforms: int, tile_rows: int) -> np.ndarray:
    """JAX's frame stream over N = num_tiles * tile_rows * 128 pixels,
    draw k of pixel p = (t * tile_rows + r) * 128 + l at [t, k, r, l]."""
    n = num_tiles * tile_rows * 128
    depth = max(0, -(-(n_uniforms - 2) // 8))
    cam, bounce = (np.asarray(a) for a in jax_draw_uniforms(jax.random.PRNGKey(seed), n, depth))
    rows = [cam[:, 0], cam[:, 1]] + [bounce[d, :, j] for d in range(depth) for j in range(8)]
    u = np.stack(rows[:n_uniforms])
    return u.reshape(n_uniforms, num_tiles, tile_rows, 128).transpose(1, 0, 2, 3)


CASES = [(1234, 4, 8, 8), (7, 3, 34, 8), (-5, 2, 1, 4), (2**31 - 1, 1, 13, 1)]


@pytest.mark.parametrize("seed,num_tiles,n_uniforms,tile_rows", CASES)
def test_plain_version_is_jax_threefry(seed, num_tiles, n_uniforms, tile_rows):
    got = MK.debug_uniform_stream(seed, num_tiles, n_uniforms, tile_rows, device="cpu")
    assert got.shape == (num_tiles, n_uniforms, tile_rows, 128) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), jax_stream(seed, num_tiles, n_uniforms, tile_rows))


def test_plain_version_is_what_k1_draws():
    """Draw k of a pixel is the number K1's thread for that pixel takes from
    the frame key at spp 1: integrator/tracer.draw_uniforms, as the
    megakernel's plain version draws it."""
    out = MK.debug_uniform_stream_reference(3, 2, 18, 2)
    n = 2 * 2 * 128
    cam, bounce = MK.draw_uniforms(rng.prng_key(3), n, 2)
    flat = out.permute(1, 0, 2, 3).reshape(18, n)
    assert torch.equal(flat[:2], cam.T)
    assert torch.equal(flat[2:], bounce.permute(0, 2, 1).reshape(16, n))


def test_stream_uniformity():
    out = MK.debug_uniform_stream(1234, 4, 8, device="cpu")
    flat = out.reshape(-1).double().numpy()
    n = flat.size
    assert flat.min() >= 0.0 and flat.max() < 1.0
    assert validate_rng.ks_stat(torch.from_numpy(flat)) < 1.63 / np.sqrt(n)  # KS at 1%
    assert abs(flat.mean() - 0.5) < 0.005
    assert abs(flat.var() - 1.0 / 12.0) < 0.002


def test_streams_tile_independent():
    out = MK.debug_uniform_stream(42, 8, 4, device="cpu").numpy()
    tiles = out.reshape(8, -1).astype(np.float64)
    for i in range(8):
        for j in range(i + 1, 8):
            r = np.corrcoef(tiles[i], tiles[j])[0, 1]
            assert abs(r) < 0.05, (i, j, r)
    np.testing.assert_array_equal(out, MK.debug_uniform_stream(42, 8, 4, device="cpu").numpy())
    other = MK.debug_uniform_stream(43, 8, 4, device="cpu").numpy()
    assert np.mean(out == other) < 0.01


# K4's loop body on the host: one (tile, draw) row of tile_rows x 128 draws
# per block, as csrc/uniform_stream.cu writes them.
SHIM = PRELUDE + r"""
#include "threefry.cuh"

extern "C" void host_stream(const uint32_t* keys, float* out, int num_tiles, int n_uniforms, int tile_rows) {
  const int per_tile = tile_rows * 128, n = num_tiles * per_tile;
  for (int block = 0; block < num_tiles * n_uniforms; ++block) {
    const int t = block / n_uniforms, k = block % n_uniforms;
    for (int e = 0; e < per_tile; ++e) {
      out[(int64_t)block * per_tile + e] = pt::stream_draw(keys[0], keys[1], keys[2], keys[3], n, t * per_tile + e, k);
    }
  }
}
"""


def test_host_stream_matches_plain_version(tmp_path):
    lib = build_shim(tmp_path, SHIM)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.host_stream.argtypes = [p, p, i, i, i]
    for seed, num_tiles, n_uniforms, tile_rows in CASES:
        keys = launch_keys(rng.prng_key(seed), 1)
        out = torch.empty((num_tiles, n_uniforms, tile_rows, 128), dtype=torch.float32)
        lib.host_stream(keys.data_ptr(), out.data_ptr(), num_tiles, n_uniforms, tile_rows)
        assert torch.equal(out, MK.debug_uniform_stream_reference(seed, num_tiles, n_uniforms, tile_rows)), seed


def test_wrapper_launches_nothing_on_the_cpu():
    launches = MK.debug_uniform_stream.launches
    MK.debug_uniform_stream(0, 1, 2, device="cpu")
    assert MK.debug_uniform_stream.launches == launches
    with pytest.raises(ValueError, match="unsupported device"):
        MK.debug_uniform_stream(0, 1, 2, device="meta")


def test_validate_rng_on_the_cpu(capsys):
    assert validate_rng.main(["--device", "cpu"]) == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["ok"] and result["device"] == "cpu"
    assert result["stream"]["n"] == 16 * 16 * 8 * 128
    assert result["stream"]["ks"] < result["stream"]["ks_critical_1pct"]
    assert result["independence"]["max_cross_tile_abs_corr"] < 0.05
