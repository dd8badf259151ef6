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
scene against every other tree, each pair in turns; then K3's launch (K1
that also writes the bounces each path entered alive) of the two trees
alike, counts and frames compared. Last, each instantiation's registers,
stack, spills and machine code against the other tree's. The other tree's
entry point of the scene's backend must take this tree's arguments.
`k2_pair` does the same for K2's analytical launch.

Usage:
  python -m pathtracer_tpu_torch.tools.k1_pair --other DIR [DIR ...] [--scene analytical sdf]
"""

from __future__ import annotations

import argparse
import json
import re
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


def launcher(csrc: Path, k: mk.KernelLaunch, occupancy: bool = False):
    """A call of `csrc`'s K1 with launch `k`'s backend, into a frame of its
    own; with `occupancy`, of its K3, returning the frame and the counts
    (int32 [spp, H, W]) as one tensor of int32 bits."""
    lib = _build.load("megakernel_fwd", csrc=csrc)
    b = mk.BACKENDS[k.backend]
    entry = getattr(lib, b.occupancy if occupancy else b.entry)
    out = torch.empty_like(k.out)
    entered = torch.empty((k.spp,) + k.out.shape[:2], dtype=torch.int32, device=out.device)
    head = (entered.data_ptr(),) if occupancy else ()
    stream = torch.cuda.current_stream(out.device).cuda_stream

    def run() -> torch.Tensor:
        err = entry(
            k.sv.data_ptr(), k.sv.shape[1], k.keys.data_ptr(), out.data_ptr(), *head, WIDTH, HEIGHT, k.spp,
            k.depth, k.n_lights, k.n_materials, k.flags, *(t.data_ptr() for t in k.extras), *k.counts, stream,
        )
        if err != 0:
            raise RuntimeError(f"launch failed: {lib.pt_error_string(err).decode()}")
        return torch.cat([out.view(torch.int32).reshape(-1), entered.reshape(-1)]) if occupancy else out

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


_INSTANCE = re.compile(r"render_forward_kernelINS_\d+(\w+?)ELb([01])E(?:Lb([01])E)?E")


def k1_key(name: str):
    """(backend, COUNT, MEDIA) of an instantiation of K1's template named in
    `name` (a tree without the MEDIA parameter has MEDIA false), or None."""
    m = _INSTANCE.search(name)
    return (m.group(1), m.group(2) == "1", m.group(3) == "1") if m else None


def instantiations(csrc: Path, kernel: str = "megakernel_fwd", key=k1_key) -> dict:
    """key(name) -> ptxas's resource lines of that instantiation of the
    template `key` recognises (K1's by default) in `csrc`'s build of
    `kernel`: its stack and spills, its registers."""
    log = (_build.build(csrc=csrc) / f"build_{kernel}.log").read_text().splitlines()
    out, k = {}, None
    for line in log:
        if "Compiling entry" in line:
            k = key(line)
            if k:
                out[k] = []
        elif k and ("registers" in line or "spill" in line):
            out[k].append(line.split(":", 1)[-1].strip())
    return {k: "; ".join(v) for k, v in out.items()}


def sass(csrc: Path, kernel: str = "megakernel_fwd", key=k1_key) -> dict:
    """key(name) -> the machine code of that instantiation in `csrc`'s build
    of `kernel`, as cuobjdump lists it without addresses and encodings; {}
    where the toolkit has no cuobjdump."""
    tool = Path(_build.find_nvcc()).with_name("cuobjdump")
    if not tool.exists():
        return {}
    lib = _build.build(csrc=csrc) / f"lib{kernel}.so"
    listing = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True, check=True).stdout
    out, k = {}, None
    for line in listing.splitlines():
        if "Function :" in line:
            k = key(line)
            if k:
                out[k] = []
        elif k:
            code = re.sub(r"/\*[^*]*\*/", "", line).strip()
            if code and not code.startswith("."):
                out[k].append(code)
    return {k: "\n".join(v) for k, v in out.items()}


def same_resources(other: Path, log=print) -> bool:
    """Whether each instantiation of `other`'s K1 template has this tree's
    registers, stack and spills (this tree's media instantiations aside);
    logs them, and whether their machine code is the same instruction for
    instruction."""
    other_csrc = (Path(other) / "pathtracer_tpu_torch" / "csrc").resolve()
    mine, theirs = instantiations(_build.CSRC), instantiations(other_csrc)
    same = bool(theirs) and all(mine.get(k) == v for k, v in theirs.items())
    my_code, their_code = sass(_build.CSRC), sass(other_csrc)
    for k, v in sorted(theirs.items()):
        code = ("machine code not listed (no cuobjdump)" if not their_code else
                f"machine code {'the same' if my_code.get(k) == their_code.get(k) else 'DIFFERENT'} "
                f"({len(their_code.get(k, '').splitlines())} instructions)")
        log(f"  {k[0]} {'K3' if k[1] else 'K1'}: this {mine.get(k)}; other {v}; {code}")
    return same


def pair(others: list[Path], scenes=("analytical",), log=print) -> list[dict]:
    """K1's and K3's launches of each of `others`' trees against this
    one's, in turns, on the demo scene of each family in `scenes`."""
    card = card_name()
    results = []
    for family in scenes:
        scene = families.make_family_scene(family, recursion_depth=DEPTH, device=torch.device("cuda", 0))
        k = mk.prepare_launch(scene, rng.prng_key(5), WIDTH, HEIGHT, 1, VERBATIM)
        for other in others:
            other_csrc = (Path(other) / "pathtracer_tpu_torch" / "csrc").resolve()
            for occ in (False, True):
                runs = {"other": launcher(other_csrc, k, occ), "this": launcher(_build.CSRC, k, occ)}
                name = "K3" if occ else "K1"
                label = f"{name} {family} launch at {WIDTH}x{HEIGHT}, depth {DEPTH}, spp 1, against {other}"
                results.append({"kernel": name, "scene": family, "other": str(other),
                                **in_turns(runs, label, card, log)})
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--other", required=True, nargs="+", type=Path, help="root of each other checkout")
    ap.add_argument("--scene", nargs="+", default=["analytical"], choices=families.FAMILIES,
                    help="the demo scenes whose backends to time")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k1_pair needs a CUDA device")
    card = card_name()
    results = pair(args.other, args.scene)
    for other in args.other:
        print(f"K1's and K3's instantiations against {other}:")
        same_resources(other)
    print(card)
    print(json.dumps(results if len(results) > 1 else results[0]))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
