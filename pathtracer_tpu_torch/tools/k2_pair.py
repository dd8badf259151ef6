"""Time K2's launch built from two source trees, in turns, on one card.

The sibling of `k1_pair` for the backward kernel: builds the kernels of
this checkout and of another one (for instance a parent commit unpacked
with `git archive` into a directory that `.gitignore` lists) through
`ops/_build`, and launches each tree's K2 on the same packed demo scene,
key and numpy-seeded cotangent at 1920x1080, depth 4, spp 1, in the order
other, this, this, other, three times. Prints the mean launch time of each
(CUDA events, 20 launches after a warm-up), their ratio, whether the two
gradients are bit-equal, and the card's name and power limit; the last
line is the same as one JSON object. With several scenes (`--scene
analytical sdf mesh`, the demo scenes of the families K2 takes) or several
other trees, every scene against every other tree, each pair in turns.
The other tree's entry point of the scene's backend must take this tree's
arguments (a tree from before a backend's K2 has none to time). Last, as
`k1_pair.same_resources` does for K1, each media-free instantiation of
K2's template against the other tree's: its registers, stack, spills and
machine code (this tree's MEDIA instantiations, a library of their own,
aside).

Usage:
  python -m pathtracer_tpu_torch.tools.k2_pair --other DIR [DIR ...] [--scene analytical sdf]
"""

from __future__ import annotations

import argparse
import json
import re
from pathlib import Path

import numpy as np
import torch

from ..integrator.tracer import VERBATIM
from ..models import families
from ..ops import _build, rng
from ..ops import megakernel as mk
from .k1_pair import DEPTH, HEIGHT, WIDTH, card_name, in_turns, instantiations, registers, sass

# the families whose demo scenes K2 takes
SCENES = tuple(name for name, b in mk.BACKENDS.items() if b.backward is not None)


_INSTANCE = re.compile(r"render_backward_kernelINS_\d+(\w+?)E(?:Lb([01])E)?E")


def k2_key(name: str):
    """(backend, MEDIA) of an instantiation of K2's template named in `name`
    (a tree without the MEDIA parameter has MEDIA false), or None."""
    m = _INSTANCE.search(name)
    return (m.group(1), m.group(2) == "1") if m else None


def same_resources(other: Path, log=print) -> bool:
    """Whether each instantiation of `other`'s K2 template has this tree's
    registers, stack and spills and the same machine code instruction for
    instruction (where the toolkit lists it; this tree's MEDIA
    instantiations aside); logs each."""
    other_csrc = (Path(other) / "pathtracer_tpu_torch" / "csrc").resolve()
    mine, theirs = (instantiations(c, "megakernel_bwd", k2_key) for c in (_build.CSRC, other_csrc))
    my_code, their_code = (sass(c, "megakernel_bwd", k2_key) for c in (_build.CSRC, other_csrc))
    same = bool(theirs)
    for k, v in sorted(theirs.items()):
        code_same = my_code.get(k) == their_code.get(k)
        same = same and mine.get(k) == v and code_same
        code = ("machine code not listed (no cuobjdump)" if not their_code else
                f"machine code {'the same' if code_same else 'DIFFERENT'} "
                f"({len(their_code.get(k, '').splitlines())} instructions)")
        log(f"  {k[0]} K2: this {mine.get(k)}; other {v}; {code}")
    for k, v in sorted(instantiations(_build.CSRC, "megakernel_bwd_media", k2_key).items()):
        log(f"  {k[0]} K2 MEDIA (this tree only, megakernel_bwd_media.cu): {v}")
    return same


def launcher(csrc: Path, k: mk.KernelLaunch, ct: torch.Tensor):
    """A call of `csrc`'s K2 with launch `k`'s backend on cotangent `ct`,
    into a gradient of its own."""
    lib = _build.load("megakernel_bwd", csrc=csrc)
    entry = getattr(lib, mk.BACKENDS[k.backend].backward)
    height, width = k.out.shape[:2]
    n_sv = k.sv.shape[1]
    partial = torch.empty((-(-width * height // lib.pt_backward_threads()), n_sv), device=k.sv.device)
    grad = torch.empty((1, n_sv), device=k.sv.device)
    stream = torch.cuda.current_stream(grad.device).cuda_stream

    def run() -> torch.Tensor:
        err = entry(
            k.sv.data_ptr(), n_sv, k.keys.data_ptr(), ct.data_ptr(), partial.data_ptr(), grad.data_ptr(), width,
            height, k.spp, k.depth, k.n_lights, k.n_materials, k.flags, *(t.data_ptr() for t in k.extras),
            *k.counts, stream,
        )
        if err != 0:
            raise RuntimeError(f"launch failed: {lib.pt_error_string(err).decode()}")
        return grad

    return run


def pair(others: list[Path], scenes=("analytical",), log=print) -> list[dict]:
    """K2's launch of each of `others`' trees against this one's, in turns
    (k1_pair.in_turns), on the demo scene of each family in `scenes`."""
    dev = torch.device("cuda", 0)
    card = card_name()
    ct = torch.from_numpy(np.random.default_rng(9).standard_normal((HEIGHT, WIDTH, 4)).astype(np.float32)).to(dev)
    results = []
    for family in scenes:
        scene = families.make_family_scene(family, recursion_depth=DEPTH, device=dev)
        k = mk.prepare_launch(scene, rng.prng_key(5), WIDTH, HEIGHT, 1, VERBATIM)
        for other in others:
            other_csrc = (Path(other) / "pathtracer_tpu_torch" / "csrc").resolve()
            runs = {"other": launcher(other_csrc, k, ct), "this": launcher(_build.CSRC, k, ct)}
            label = f"K2 {family} launch at {WIDTH}x{HEIGHT}, depth {DEPTH}, spp 1, against {other}"
            results.append({"scene": family, "other": str(other), **in_turns(runs, label, card, log)})
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--other", required=True, nargs="+", type=Path, help="root of each other checkout")
    ap.add_argument("--scene", nargs="+", default=["analytical"], choices=SCENES,
                    help="the demo scenes whose backends to time")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k2_pair needs a CUDA device")
    results = pair(args.other, args.scene)
    for csrc in [_build.CSRC] + [(other / "pathtracer_tpu_torch" / "csrc").resolve() for other in args.other]:
        print(f"K2 build of {csrc}:")
        for line in registers(csrc, "megakernel_bwd", "render_backward_kernel"):
            print("  " + line)
    for other in args.other:
        print(f"K2's instantiations against {other}:")
        same_resources(other)
    print(results[0]["card"])
    print(json.dumps(results if len(results) > 1 else results[0]))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
