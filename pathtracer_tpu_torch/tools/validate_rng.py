"""Validate the megakernels' in-kernel uniform stream on the card.

The port of the JAX package's `scripts/validate_rng.py`. It draws the
stream through K4 (`ops/megakernel.debug_uniform_stream`, the draws K1's
threads make) and prints one JSON line of:

1. uniformity of the pooled stream: min, max, mean, variance, the
   Kolmogorov-Smirnov statistic against its 1% critical value 1.63/sqrt(n);
2. independence: the largest |correlation| between the streams of two
   tiles, the largest per-tile KS statistic, and the share of draws equal
   to those of the next frame seed.

`ok` is whether each passes JAX's thresholds; the exit code is 0 when it
does. JAX's third check, the agreement of images rendered with the "hbm"
and the "inkernel" estimators, has no counterpart: the port has one stream,
threefry at JAX's counters, so "hbm" and "inkernel" are one estimator here.
`chip_smoke.py` phase 3 holds K1 to a plain version that draws the same
numbers. It writes no RNG_VALIDATION.json, which stays the TPU's record.

Usage:
  python -m pathtracer_tpu_torch.tools.validate_rng [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json

import torch

from ..ops.megakernel import debug_uniform_stream

NUM_TILES, N_UNIFORMS, TILE_ROWS, SEED = 16, 16, 8, 1234


def ks_stat(x: torch.Tensor) -> float:
    """The Kolmogorov-Smirnov distance of the draws x from U(0, 1)."""
    s = torch.sort(x.reshape(-1).double()).values
    n = s.numel()
    grid = torch.arange(1, n + 1, dtype=torch.float64, device=s.device) / n
    return float(torch.maximum((s - grid).abs(), (s - grid + 1.0 / n).abs()).max())


def stream_stats(out: torch.Tensor) -> dict:
    """Uniformity of the pooled draws of a [tiles, ...] stream."""
    flat = out.reshape(-1).double()
    n = flat.numel()
    return {
        "n": n, "min": float(flat.min()), "max": float(flat.max()), "mean": float(flat.mean()),
        "var": float(flat.var(unbiased=False)), "ks": ks_stat(flat), "ks_critical_1pct": 1.63 / n**0.5,
    }


def independence(out: torch.Tensor, other: torch.Tensor) -> dict:
    """Across the tiles of one stream and against another frame seed's."""
    tiles = out.reshape(out.shape[0], -1).double()
    corr = torch.corrcoef(tiles).abs()
    off = ~torch.eye(tiles.shape[0], dtype=torch.bool, device=tiles.device)
    return {
        "max_cross_tile_abs_corr": float(corr[off].max()),
        "cross_seed_collision_rate": float((out == other).double().mean()),
        "per_tile_ks_max": max(ks_stat(t) for t in tiles),
    }


def passes(result: dict) -> bool:
    """JAX's thresholds (scripts/validate_rng.py) on the stream checks."""
    st, ind = result["stream"], result["independence"]
    return (st["ks"] < st["ks_critical_1pct"] and st["max"] < 1.0 and st["min"] >= 0.0
            and abs(st["mean"] - 0.5) < 0.005 and ind["max_cross_tile_abs_corr"] < 0.05
            and ind["cross_seed_collision_rate"] < 0.01)


def validate(device="cuda", seed: int = SEED, num_tiles: int = NUM_TILES, n_uniforms: int = N_UNIFORMS,
             tile_rows: int = TILE_ROWS) -> dict:
    """The stream of frame seed `seed` and of seed + 1, both through
    debug_uniform_stream on `device`, and their statistics."""
    out = debug_uniform_stream(seed, num_tiles, n_uniforms, tile_rows, device=device)
    other = debug_uniform_stream(seed + 1, num_tiles, n_uniforms, tile_rows, device=device)
    result = {"device": str(out.device), "stream": stream_stats(out), "independence": independence(out, other)}
    result["ok"] = passes(result)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda", help="cuda | cuda:N | cpu (the plain version)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: CUDA is not available")
    result = validate(device)
    if device.type == "cuda":
        result["card"] = torch.cuda.get_device_name(device)
    print(json.dumps(result))
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
