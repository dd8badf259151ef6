"""Time K2's analytical launch built from two source trees, in turns, on
one card.

The sibling of `k1_pair` for the backward kernel: builds the kernels of
this checkout and of another one (for instance a parent commit unpacked
with `git archive` into a directory that `.gitignore` lists) through
`ops/_build`, and launches each tree's K2 on the same packed demo scene,
key and numpy-seeded cotangent at 1920x1080, depth 4, spp 1, in the order
other, this, this, other, three times. Prints the mean launch time of each
(CUDA events, 20 launches after a warm-up), their ratio, whether the two
gradients are bit-equal, and the card's name and power limit; the last
line is the same as one JSON object. The other tree's `pt_render_backward`
must take this tree's arguments.

Usage:
  python -m pathtracer_tpu_torch.tools.k2_pair --other DIR
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from ..integrator.tracer import VERBATIM
from ..models.analytical import make_scene
from ..ops import _build, rng
from ..ops import megakernel as mk
from .k1_pair import DEPTH, HEIGHT, WIDTH, card_name, in_turns


def launcher(csrc: Path, k: mk.KernelLaunch, ct: torch.Tensor):
    """A call of `csrc`'s K2 on launch `k` and cotangent `ct`, into a
    gradient of its own."""
    lib = _build.load("megakernel_bwd", csrc=csrc)
    height, width = k.out.shape[:2]
    n_sv = k.sv.shape[1]
    partial = torch.empty((-(-width * height // lib.pt_backward_threads()), n_sv), device=k.sv.device)
    grad = torch.empty((1, n_sv), device=k.sv.device)
    stream = torch.cuda.current_stream(grad.device).cuda_stream

    def run() -> torch.Tensor:
        err = lib.pt_render_backward(
            k.sv.data_ptr(), n_sv, k.keys.data_ptr(), ct.data_ptr(), partial.data_ptr(), grad.data_ptr(), width,
            height, k.spp, k.depth, k.n_lights, k.n_materials, k.flags, stream,
        )
        if err != 0:
            raise RuntimeError(f"launch failed: {lib.pt_error_string(err).decode()}")
        return grad

    return run


def pair(other: Path, log=print) -> dict:
    """K2's analytical launch of `other`'s tree against this one's, in
    turns (k1_pair.in_turns)."""
    dev = torch.device("cuda", 0)
    scene = make_scene(recursion_depth=DEPTH, device=dev)
    k = mk.prepare_launch(scene, rng.prng_key(5), WIDTH, HEIGHT, 1, VERBATIM)
    ct = torch.from_numpy(np.random.default_rng(9).standard_normal((HEIGHT, WIDTH, 4)).astype(np.float32)).to(dev)
    other_csrc = (other / "pathtracer_tpu_torch" / "csrc").resolve()
    runs = {"other": launcher(other_csrc, k, ct), "this": launcher(_build.CSRC, k, ct)}
    return in_turns(runs, f"K2 analytical launch at {WIDTH}x{HEIGHT}, depth {DEPTH}, spp 1", card_name(), log)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--other", required=True, type=Path, help="root of the other checkout")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k2_pair needs a CUDA device")
    result = pair(args.other)
    print(result["card"])
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
