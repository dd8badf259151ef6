"""Time K1's analytical launch built from two source trees, in turns, on
one card.

Builds the kernels of this checkout and of another one (for instance a
parent commit unpacked with `git archive` into a directory that
`.gitignore` lists) through `ops/_build`, and launches each tree's K1 on
the same packed demo scene and key at 1920x1080, depth 4, spp 1, in the
order other, this, this, other, three times. Prints the mean launch time
of each (CUDA events, 20 launches after a warm-up), their ratio, whether
the two frames are bit-equal, and the card's name and power limit; the
last line is the same as one JSON object. The other tree's
`pt_render_forward` must take this tree's arguments. `k2_pair` does the
same for K2's analytical launch.

Usage:
  python -m pathtracer_tpu_torch.tools.k1_pair --other DIR
"""

from __future__ import annotations

import argparse
import json
import subprocess
from pathlib import Path

import torch

from ..integrator.tracer import VERBATIM
from ..models.analytical import make_scene
from ..ops import _build, rng
from ..ops import megakernel as mk
from ..utils.timing import cuda_ms

WIDTH, HEIGHT, DEPTH = 1920, 1080, 4
ROUNDS, LAUNCHES = 3, 20


def launcher(csrc: Path, k: mk.KernelLaunch):
    """A call of `csrc`'s K1 on launch `k`, into a frame of its own."""
    lib = _build.load("megakernel_fwd", csrc=csrc)
    out = torch.empty_like(k.out)
    stream = torch.cuda.current_stream(out.device).cuda_stream

    def run() -> torch.Tensor:
        err = lib.pt_render_forward(
            k.sv.data_ptr(), k.sv.shape[1], k.keys.data_ptr(), out.data_ptr(), WIDTH, HEIGHT, k.spp, k.depth,
            k.n_lights, k.n_materials, k.flags, stream,
        )
        if err != 0:
            raise RuntimeError(f"launch failed: {lib.pt_error_string(err).decode()}")
        return out

    return run


def card_name() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def in_turns(runs: dict, label: str, card: str, log=print) -> dict:
    """Time runs["other"] and runs["this"] (each returns its output) in the
    order other, this, this, other, ROUNDS times, LAUNCHES calls each after
    a warm-up; print and return the means, their ratio, each timing and
    whether the two outputs are bit-equal."""
    bit_equal = bool(torch.equal(runs["other"](), runs["this"]()))
    times = {"other": [], "this": []}
    for _ in range(ROUNDS):
        for name in ("other", "this", "this", "other"):
            times[name].append(cuda_ms(runs[name], LAUNCHES))
    mean = {name: sum(t) / len(t) for name, t in times.items()}
    log(f"{label} ({card}):")
    for name in ("other", "this"):
        log(f"  {name}: {mean[name]:.4f} ms (each timing: {', '.join(f'{t:.4f}' for t in times[name])})")
    log(f"  this / other = {mean['this'] / mean['other']:.4f}; outputs bit-equal: {bit_equal}")
    return {"card": card, "other_ms": mean["other"], "this_ms": mean["this"], "ratio": mean["this"] / mean["other"],
            "bit_equal": bit_equal, "times": times}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--other", required=True, type=Path, help="root of the other checkout")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k1_pair needs a CUDA device")
    card = card_name()
    scene = make_scene(recursion_depth=DEPTH, device=torch.device("cuda", 0))
    k = mk.prepare_launch(scene, rng.prng_key(5), WIDTH, HEIGHT, 1, VERBATIM)
    other_csrc = (args.other / "pathtracer_tpu_torch" / "csrc").resolve()
    runs = {"other": launcher(other_csrc, k), "this": launcher(_build.CSRC, k)}
    result = in_turns(runs, f"K1 analytical launch at {WIDTH}x{HEIGHT}, depth {DEPTH}, spp 1", card)
    print(card)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
