"""Time K2 built from two source trees, in turns, on one card.

The sibling of `k1_pair` for the backward kernel: builds the kernels of
this checkout and of another one (for instance a parent commit unpacked
with `git archive` into a directory that `.gitignore` lists) through
`ops/_build`, and runs each tree's K2 on the same packed demo scene, key
and numpy-seeded cotangent at 1920x1080, depth 4, spp 1, in the order
other, this, this, other, three times. This tree's K2 goes through
`ops/megakernel.launch_backward` (its record kernel, adjoint kernel and
reduction); the other tree's the same way with its own kernels (the SDF
scene's from its library for the scene's counts where the tree builds one).
Prints the mean time of each (CUDA events, 20 calls after a warm-up),
their ratio, whether the two gradients are bit-equal and, where they are
not, the largest difference over the largest entry; the same for the
record kernels alone, their records compared bit for bit; and the card's
name and power limit. The last line is the same as one JSON object.
With several scenes (`--scene analytical sdf mesh media`: the demo scenes
of the families K2 takes, and `media`, the analytical glass filled with the
Scatter demo's medium at depth 6, K2's MEDIA instantiation) or several
other trees, every scene against every other tree, each pair in turns.
Last, as `k1_pair.resources` does for K1, each instantiation of K2's
kernels in both trees: its registers, stack and spills (the two designs
differ, so they are printed, not compared). With `--contracted`, also K2
MEDIA's record and adjoint kernels built with nvcc's FMA contraction
against the shipped -fmad=false build, each kernel in turns (`contracted`).

Usage:
  python -m pathtracer_tpu_torch.tools.k2_pair --other DIR [DIR ...] [--scene analytical sdf mesh media]
  python -m pathtracer_tpu_torch.tools.k2_pair --contracted
"""

from __future__ import annotations

import argparse
import ctypes
import json
from pathlib import Path

import numpy as np
import torch

from ..integrator.tracer import VERBATIM
from ..models import families
from ..ops import _build, rng
from ..ops import megakernel as mk
from .k1_pair import (DEPTH, HEIGHT, MEDIA_DEPTH, WIDTH, backward_library, card_name, in_turns, instance,
                      instantiations, media_demo, mesh_rounds_apart, sass)

# the families whose demo scenes K2 takes, and the media demo
SCENES = tuple(name for name, b in mk.BACKENDS.items() if b.backward is not None) + ("media",)


def k2_key(text: str):
    """(kernel, backend, MEDIA) of an instantiation of one of K2's kernel
    templates (record_kernel or adjoint_kernel) named in the demangled
    `text`, the backend without its counts (SdfAdj<SdfCounts<1, 1, 1>> ->
    SdfAdj), or None."""
    for kernel in ("record_kernel", "adjoint_kernel"):
        m = instance(text, kernel, 1)
        if m:
            return (kernel, *m)
    return None


def _libraries(csrc: Path) -> tuple:
    """The libraries of `csrc`'s tree that hold K2's analytical and mesh
    instantiations (the small mesh's media-free ones in `megakernel_mesh`
    where the tree has it)."""
    return ("megakernel_bwd", "megakernel_bwd_media") + (("megakernel_mesh",) if mesh_rounds_apart(csrc) else ())


def same_code(other: Path, log=print) -> bool:
    """Whether the analytical and mesh instantiations of K2's kernels
    (`_libraries`) have `other`'s machine code, instruction for
    instruction, where cuobjdump lists it; logs each."""
    other_csrc = (Path(other) / "pathtracer_tpu_torch" / "csrc").resolve()
    mine, theirs = ({k: v for kernel in _libraries(csrc) for k, v in sass(csrc, kernel, k2_key).items()}
                    for csrc in (_build.CSRC, other_csrc))
    same = True
    for k in sorted(key for key in theirs if key[1] in ("AnalyticalAdj", "MeshAdj")):
        equal = mine.get(k) == theirs[k]
        same = same and equal
        log(f"  {k[1]} {k[0]}{' MEDIA' if k[2] else ''}: machine code {'the same' if equal else 'DIFFERENT'} "
            f"({len(theirs[k].splitlines())} instructions)")
    return same


def resources(other: Path, counts=(1, 1, 1), log=print) -> None:
    """Each instantiation of K2's kernels in this tree and in `other` (the
    SDF scene's in its library for `counts`, where the tree builds one):
    its registers, stack and spills as ptxas printed them."""
    for label, csrc in (("this", _build.CSRC), ("other", (Path(other) / "pathtracer_tpu_torch" / "csrc").resolve())):
        libs = [(kernel, None) for kernel in _libraries(csrc)]
        libs += [(kernel, counts) for kernel in _build.per_count_kernels(csrc)]
        for kernel, c in libs:
            if not (csrc / f"{kernel}.cu").exists():
                continue
            for k, v in sorted(instantiations(csrc, kernel, k2_key, counts=c).items()):
                log(f"  {label}: {k[1]} {k[0]}{' MEDIA' if k[2] else ''}: {v}")


def _ok(err: int, lib) -> None:
    if err != 0:
        raise RuntimeError(f"launch failed: {lib.pt_error_string(err).decode()}")


def other_launcher(csrc: Path, k: mk.KernelLaunch, ct: torch.Tensor):
    """A call of `csrc`'s K2 with launch `k`'s backend and instantiation on
    cotangent `ct`, into a gradient of its own: the same chunks as
    ops/megakernel.launch_backward with that tree's kernels, uncounted."""
    lib = _build.load("megakernel_bwd", csrc=csrc)  # the reduction
    height, width = k.out.shape[:2]
    n_sv = k.sv.shape[1]
    blocks = -(-width * height // 128)
    partial = torch.empty((blocks, n_sv), device=k.sv.device)
    grad = torch.empty((1, n_sv), device=k.sv.device)
    stream = torch.cuda.current_stream(grad.device).cuda_stream
    record, adjoint, entry_lib = mk.backward_entries(k, backward_library(k, csrc))
    rec, chunks = mk.record_buffer(k), mk.record_chunks(k)

    def run() -> torch.Tensor:
        for chunk in chunks:
            _ok(record(*mk.record_args(k, rec, chunk)), entry_lib)
            _ok(adjoint(*mk.adjoint_args(k, ct, rec, partial, chunk)), entry_lib)
        _ok(lib.pt_backward_reduce(partial.data_ptr(), blocks, n_sv, grad.data_ptr(), stream), lib)
        return grad

    return run


def pair(others: list[Path], scenes=("analytical",), log=print) -> list[dict]:
    """K2 of each of `others`' trees against this one's, in turns
    (k1_pair.in_turns), on the demo scene of each family in `scenes`
    ("media": media_demo); each result also holds `max_rel`, the largest
    difference of the two gradients over the largest entry of the other's."""
    dev = torch.device("cuda", 0)
    card = card_name()
    ct = torch.from_numpy(np.random.default_rng(9).standard_normal((HEIGHT, WIDTH, 4)).astype(np.float32)).to(dev)
    results = []
    for family in scenes:
        if family == "media":
            scene, depth = media_demo(dev), MEDIA_DEPTH
        else:
            scene, depth = families.make_family_scene(family, recursion_depth=DEPTH, device=dev), DEPTH
        k = mk.prepare_launch(scene, rng.prng_key(5), WIDTH, HEIGHT, 1, VERBATIM)
        for other in others:
            other_csrc = (Path(other) / "pathtracer_tpu_torch" / "csrc").resolve()
            runs = {"other": other_launcher(other_csrc, k, ct), "this": lambda: mk.launch_backward(k, ct)}
            theirs, mine = runs["other"]().clone(), runs["this"]()
            max_rel = float((mine - theirs).abs().max() / theirs.abs().max())
            label = f"K2 {family} at {WIDTH}x{HEIGHT}, depth {depth}, spp 1, against {other}"
            r = in_turns(runs, label, card, log)
            if not r["bit_equal"]:
                log(f"  largest difference {max_rel:.3e} of the other's largest entry")
            records = in_turns({"other": record_launcher(k, other_csrc), "this": record_launcher(k)},
                               f"K2 {family}'s record kernel alone, against {other} (outputs: the records)", card,
                               log)
            results.append({"scene": family, "other": str(other), "max_rel": max_rel, **r, "record": records})
    return results


def record_launcher(k: mk.KernelLaunch, csrc: Path | None = None):
    """A call of K2's record kernel of `csrc`'s tree (this one's by
    default) for launch `k`, every chunk, into a record buffer of its own,
    uncounted; returns the buffer (zeroed first, so that the words past a
    path's end compare too)."""
    record, _, lib = mk.backward_entries(k, csrc and backward_library(k, csrc))
    rec, chunks = mk.record_buffer(k).zero_(), mk.record_chunks(k)

    def run() -> torch.Tensor:
        for chunk in chunks:
            _ok(record(*mk.record_args(k, rec, chunk)), lib)
        return rec

    return run


def contracted(log=print) -> list[dict]:
    """K2 MEDIA built with nvcc's FMA contraction (the default flags,
    without megakernel_bwd_media.cu's -fmad=false; `other`) against the
    shipped build (`this`), in turns on the media demo at 1920x1080, depth
    6: each record kernel, then each adjoint kernel on the shipped record
    kernel's records. Timing only: the contracted build is not held to the
    plain version, and nothing uses it."""
    import shutil

    dev = torch.device("cuda", 0)
    card = card_name()
    src = _build.BUILD_ROOT.parent / "k2_media_contracted"
    shutil.rmtree(src, ignore_errors=True)
    src.mkdir(parents=True)
    for header in _build.CSRC.glob("*.cuh"):
        shutil.copy(header, src)
    shutil.copy(_build.CSRC / "megakernel_bwd_media.cu", src / "megakernel_bwd_media_contracted.cu")
    lib = ctypes.CDLL(str(_build.build(csrc=src) / "libmegakernel_bwd_media_contracted.so"))
    lib.pt_error_string.argtypes, lib.pt_error_string.restype = [ctypes.c_int], ctypes.c_char_p
    k = mk.prepare_launch(media_demo(dev), rng.prng_key(5), WIDTH, HEIGHT, 1, VERBATIM)
    ct = torch.from_numpy(np.random.default_rng(9).standard_normal((HEIGHT, WIDTH, 4)).astype(np.float32)).to(dev)
    entries = {}
    for kernel in ("record", "adjoint"):
        name = f"{mk.BACKENDS[k.backend].media_backward}_{kernel}"
        entries[kernel] = getattr(lib, name)
        entries[kernel].argtypes, entries[kernel].restype = _build.SIGNATURES["megakernel_bwd_media"][name]
    (chunk,) = mk.record_chunks(k)
    rec, rec_contracted = mk.record_buffer(k), mk.record_buffer(k)
    partial, partial_contracted = (torch.empty((-(-WIDTH * HEIGHT // 128), k.sv.shape[1]), device=dev)
                                   for _ in range(2))

    def record(buf, entry=None):
        def run():
            if entry is None:
                mk.launch_record(k, buf, chunk)
            else:
                _ok(entry(*mk.record_args(k, buf, chunk)), lib)
            return buf
        return run

    def adjoint(buf, entry=None):
        def run():
            if entry is None:
                mk.launch_adjoint(k, ct, rec, buf, chunk)
            else:
                _ok(entry(*mk.adjoint_args(k, ct, rec, buf, chunk)), lib)
            return buf
        return run

    return [in_turns({"other": record(rec_contracted, entries["record"]), "this": record(rec)},
                     f"K2 MEDIA record kernel at {WIDTH}x{HEIGHT}, depth {MEDIA_DEPTH}, other = contracted, this = "
                     "-fmad=false (outputs: the records)", card, log),
            in_turns({"other": adjoint(partial_contracted, entries["adjoint"]), "this": adjoint(partial)},
                     f"K2 MEDIA adjoint kernel at {WIDTH}x{HEIGHT} on the -fmad=false records, other = contracted, "
                     "this = -fmad=false (outputs: the block sums)", card, log)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--other", nargs="+", default=[], type=Path, help="root of each other checkout")
    ap.add_argument("--scene", nargs="+", default=["analytical"], choices=SCENES,
                    help="the demo scenes whose K2 to time")
    ap.add_argument("--contracted", action="store_true",
                    help="also time K2 MEDIA's kernels built with FMA contraction against the shipped build")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k2_pair needs a CUDA device")
    if not args.other and not args.contracted:
        ap.error("nothing to pair: give --other DIR or --contracted")
    results = pair(args.other, args.scene) + (contracted() if args.contracted else [])
    for other in args.other:
        print(f"K2's kernels in this tree and in {other}:")
        resources(other)
        same_code(other)
    print(results[0]["card"])
    print(json.dumps(results if len(results) > 1 else results[0]))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
