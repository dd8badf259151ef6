"""Time K1's launch built from two source trees, in turns, on one card.

Builds the kernels of this checkout and of another one (for instance a
parent commit unpacked with `git archive` into a directory that
`.gitignore` lists) through `ops/_build`, and launches each tree's K1 on
the same packed demo scene and key at 1920x1080, depth 4, spp 1, in the
order other, this, this, other, three times. Prints the mean launch time
of each (CUDA events, 20 launches after a warm-up), their ratio, whether
the two frames are bit-equal, and the card's name and power limit; the
last line is the same as one JSON object. With several scenes (`--scene
analytical sdf`, the backends' demo scenes) or several other trees, every
scene against every other tree, each pair in turns. The other tree's entry
point of the scene's backend must take this tree's arguments. `k2_pair`
does the same for K2's analytical launch.

Usage:
  python -m pathtracer_tpu_torch.tools.k1_pair --other DIR [DIR ...] [--scene analytical sdf]
"""

from __future__ import annotations

import argparse
import json
import subprocess
from pathlib import Path

import torch

from ..integrator.tracer import VERBATIM
from ..models import families
from ..ops import _build, rng
from ..ops import megakernel as mk
from ..utils.timing import cuda_ms

WIDTH, HEIGHT, DEPTH = 1920, 1080, 4
ROUNDS, LAUNCHES = 3, 20


def launcher(csrc: Path, k: mk.KernelLaunch):
    """A call of `csrc`'s K1 with launch `k`'s backend, into a frame of its
    own."""
    lib = _build.load("megakernel_fwd", csrc=csrc)
    entry = getattr(lib, mk.BACKENDS[k.backend].entry)
    out = torch.empty_like(k.out)
    stream = torch.cuda.current_stream(out.device).cuda_stream

    def run() -> torch.Tensor:
        err = entry(
            k.sv.data_ptr(), k.sv.shape[1], k.keys.data_ptr(), out.data_ptr(), WIDTH, HEIGHT, k.spp, k.depth,
            k.n_lights, k.n_materials, k.flags, *(t.data_ptr() for t in k.extras), *k.counts, stream,
        )
        if err != 0:
            raise RuntimeError(f"launch failed: {lib.pt_error_string(err).decode()}")
        return out

    return run


def registers(csrc: Path, kernel: str = "megakernel_fwd", entry: str = "render_forward_kernel") -> list[str]:
    """ptxas's lines for each instantiation of `entry` in `csrc`'s build of
    `kernel` (K1's by default): its registers, stack and spills."""
    log = (_build.build(csrc=csrc) / f"build_{kernel}.log").read_text().splitlines()
    return [line.strip() for line in log if "registers" in line or "spill" in line
            or ("Compiling entry" in line and entry in line)]


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
    ap.add_argument("--other", required=True, nargs="+", type=Path, help="root of each other checkout")
    ap.add_argument("--scene", nargs="+", default=["analytical"], choices=families.FAMILIES,
                    help="the demo scenes whose backends to time")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k1_pair needs a CUDA device")
    card = card_name()
    results = []
    for family in args.scene:
        scene = families.make_family_scene(family, recursion_depth=DEPTH, device=torch.device("cuda", 0))
        k = mk.prepare_launch(scene, rng.prng_key(5), WIDTH, HEIGHT, 1, VERBATIM)
        for other in args.other:
            other_csrc = (other / "pathtracer_tpu_torch" / "csrc").resolve()
            runs = {"other": launcher(other_csrc, k), "this": launcher(_build.CSRC, k)}
            label = f"K1 {family} launch at {WIDTH}x{HEIGHT}, depth {DEPTH}, spp 1, against {other}"
            results.append({"scene": family, "other": str(other), **in_turns(runs, label, card)})
    for csrc in [_build.CSRC] + [(other / "pathtracer_tpu_torch" / "csrc").resolve() for other in args.other]:
        print(f"K1 build of {csrc}:")
        for line in registers(csrc):
            print("  " + line)
    print(card)
    print(json.dumps(results if len(results) > 1 else results[0]))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
