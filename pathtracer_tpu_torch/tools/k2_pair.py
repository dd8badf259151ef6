"""Time K2 built from two source trees, in turns, on one card.

The sibling of `k1_pair` for the backward kernel: builds the kernels of
this checkout and of another one (for instance a parent commit unpacked
with `git archive` into a directory that `.gitignore` lists) through
`ops/_build`, and runs each tree's K2 on the same packed demo scene, key
and numpy-seeded cotangent at 1920x1080, depth 4, spp 1, in the order
other, this, this, other, three times. This tree's K2 goes through
`ops/megakernel.launch_backward` (its record kernel, adjoint kernel and
reduction); the other tree's the same way with its own kernels, or, in a
tree from before K2 became two kernels, through its one entry point with
that tree's arguments. Prints the mean time of each (CUDA events, 20 calls
after a warm-up), their ratio, whether the two gradients are bit-equal and,
where they are not, the largest difference over the largest entry, and the
card's name and power limit; the last line is the same as one JSON object.
With several scenes (`--scene analytical sdf mesh media`: the demo scenes
of the families K2 takes, and `media`, the analytical glass filled with the
Scatter demo's medium at depth 6, K2's MEDIA instantiation) or several
other trees, every scene against every other tree, each pair in turns.
Last, as `k1_pair.same_resources` does for K1, each instantiation of K2's
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
import re
from pathlib import Path

import numpy as np
import torch

from ..integrator.tracer import VERBATIM
from ..models import families
from ..models.material import MediumType
from ..models.scene import Scene
from ..ops import _build, rng
from ..ops import megakernel as mk
from .k1_pair import DEPTH, HEIGHT, WIDTH, card_name, in_turns, instantiations

# the families whose demo scenes K2 takes, and the media demo
SCENES = tuple(name for name, b in mk.BACKENDS.items() if b.backward is not None) + ("media",)
# the media demo: the analytical glass (material 1: spec_trans 1, metallic 0,
# roughness 0.05, ior 1.5) filled with the Scatter demo's medium, depth 6
MEDIA_DEPTH = 6
# A tree's K2 entry point before K2 became two kernels: sv, n_sv, keys, ct, partial, grad, the
# frame's ints and flags, the backend's, the stream.
_P, _I = ctypes.c_void_p, ctypes.c_int
ONE_KERNEL_ARGS = {
    "analytical": [_P, _I, _P, _P, _P, _P] + [_I] * 7 + [_P],
    "sdf": [_P, _I, _P, _P, _P, _P] + [_I] * 10 + [_P],
    "mesh": [_P, _I, _P, _P, _P, _P] + [_I] * 7 + [_P, _I, _I, _P],
}

_INSTANCE = re.compile(r"(render_backward_kernel|record_kernel|adjoint_kernel)INS_\d+(\w+?)E(?:Lb([01])E)?E")


def k2_key(name: str):
    """(kernel, backend, MEDIA) of an instantiation of one of K2's kernel
    templates named in `name` (the one-kernel design's
    render_backward_kernel, or record_kernel and adjoint_kernel; a tree
    without the MEDIA parameter has MEDIA false), or None."""
    m = _INSTANCE.search(name)
    return (m.group(1), m.group(2), m.group(3) == "1") if m else None


def resources(other: Path, log=print) -> None:
    """Each instantiation of K2's kernels in this tree and in `other`: its
    registers, stack and spills as ptxas printed them."""
    for label, csrc in (("this", _build.CSRC), ("other", (Path(other) / "pathtracer_tpu_torch" / "csrc").resolve())):
        for kernel in ("megakernel_bwd", "megakernel_bwd_media"):
            if not (csrc / f"{kernel}.cu").exists():
                continue
            for k, v in sorted(instantiations(csrc, kernel, k2_key).items()):
                log(f"  {label}: {k[1]} {k[0]}{' MEDIA' if k[2] else ''}: {v}")


def media_demo(dev) -> Scene:
    """The analytical glass filled with the Scatter demo's medium."""
    scene = families.make_family_scene("analytical", recursion_depth=MEDIA_DEPTH, device=dev)
    m = scene.params.materials
    with torch.no_grad():
        m.spec_trans[1], m.metallic[1], m.roughness[1], m.ior[1] = 1.0, 0.0, 0.05, 1.5
        m.medium.medium_type[1], m.medium.density[1], m.medium.anisotropy[1] = int(MediumType.SCATTER), 0.8, 0.4
        m.medium.color.x[1], m.medium.color.y[1], m.medium.color.z[1] = 0.9, 0.2, 0.1
    return scene


def _ok(err: int, lib) -> None:
    if err != 0:
        raise RuntimeError(f"launch failed: {lib.pt_error_string(err).decode()}")


def other_launcher(csrc: Path, k: mk.KernelLaunch, ct: torch.Tensor):
    """A call of `csrc`'s K2 with launch `k`'s backend and instantiation on
    cotangent `ct`, into a gradient of its own: a tree with this one's entry
    points runs the same chunks (ops/megakernel.launch_backward) with its
    own kernels, uncounted; a tree from before K2 became two kernels is
    called with its own arguments."""
    lib = _build.load("megakernel_bwd", csrc=csrc)
    height, width = k.out.shape[:2]
    n_sv = k.sv.shape[1]
    blocks = -(-width * height // 128)
    partial = torch.empty((blocks, n_sv), device=k.sv.device)
    grad = torch.empty((1, n_sv), device=k.sv.device)
    stream = torch.cuda.current_stream(grad.device).cuda_stream
    if not hasattr(lib, "pt_backward_reduce"):
        b = mk.BACKENDS[k.backend]
        entry_lib = _build.load("megakernel_bwd_media", csrc=csrc) if k.media else lib
        entry = getattr(entry_lib, b.media_backward if k.media else b.backward)
        entry.argtypes = ONE_KERNEL_ARGS[k.backend]

        def run_one() -> torch.Tensor:
            _ok(entry(k.sv.data_ptr(), n_sv, k.keys.data_ptr(), ct.data_ptr(), partial.data_ptr(), grad.data_ptr(),
                      width, height, k.spp, k.depth, k.n_lights, k.n_materials, k.flags,
                      *(t.data_ptr() for t in k.extras), *k.counts, stream), entry_lib)
            return grad

        return run_one
    record, adjoint, entry_lib = mk.backward_entries(k, csrc)
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
            results.append({"scene": family, "other": str(other), "max_rel": max_rel, **r})
    return results


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
    print(results[0]["card"])
    print(json.dumps(results if len(results) > 1 else results[0]))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
