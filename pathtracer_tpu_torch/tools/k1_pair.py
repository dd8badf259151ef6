"""Time K1's launch built from two source trees, in turns, on one card.

Builds the kernels of this checkout and of another one (for instance a
parent commit unpacked with `git archive` into a directory that
`.gitignore` lists) through `ops/_build`, and launches each tree's K1 on
the same packed demo scene and key at 1920x1080, depth 4, spp 1, in the
order other, this, this, other, three times. Prints the mean launch time
of each (CUDA events, 20 launches after a warm-up), their ratio, whether
the two frames are bit-equal, and the card's name and power limit; the
last line is the same as one JSON object. With several scenes (`--scene
analytical sdf`, the backends' demo scenes; `media`, the analytical glass
filled with the Scatter demo's medium at depth 6, and `media-sdf`,
`media-mesh`, `media-bigmesh`, each backend's glass filled alike: K1's
MEDIA instantiations) or several other trees, every scene against every
other tree, each pair in turns; then K3's launch (K1 that also writes the
bounces each path entered alive) of the two trees alike, counts and frames
compared. Each tree's SDF launch goes through its own library: this
tree's is built for the scene's primitive counts (`megakernel_sdf.cu`), an
older tree's is its `megakernel_fwd`; so does its small mesh's
(`megakernel_mesh.cu`, built without FMA contraction; in a tree older than
that file, `megakernel_fwd` and `megakernel_bwd`: `forward_library`,
`backward_library`). Last, each instantiation's
registers, stack and spills in both trees (`resources`); the toolkit's
cu++filt names each instantiation. `k2_pair` does the same for K2;
`kernels_of` runs the port's launches on another tree's kernels (the
training steps of chip_smoke.py's phase 35).

Usage:
  python -m pathtracer_tpu_torch.tools.k1_pair --other DIR [DIR ...] [--scene analytical sdf media media-sdf]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import re
import subprocess
from pathlib import Path

import torch

from ..integrator.tracer import VERBATIM
from ..models import families
from ..models.material import MediumType
from ..models.scene import Scene
from ..ops import _build, rng
from ..ops import megakernel as mk
from ..utils.timing import cuda_ms

WIDTH, HEIGHT, DEPTH = 1920, 1080, 4
ROUNDS, LAUNCHES = 3, 20
# the media demo: a family's glass (the material of MEDIA_GLASS: spec_trans
# 1, metallic 0, roughness 0.05, ior 1.5) filled with the Scatter demo's
# medium, depth 6; "media" is the analytical one, "media-<family>" another's
MEDIA_DEPTH = 6
MEDIA_GLASS = {"analytical": 1, "sdf": 0, "mesh": 1, "bigmesh": 1}
MEDIA_SCENES = {"media": "analytical", **{f"media-{f}": f for f in families.FAMILIES if f != "analytical"}}


def media_demo(dev, family: str = "analytical") -> Scene:
    """The family's glass filled with the Scatter demo's medium."""
    scene = families.make_family_scene(family, recursion_depth=MEDIA_DEPTH, device=dev)
    m, i = scene.params.materials, MEDIA_GLASS[family]
    with torch.no_grad():
        m.spec_trans[i], m.metallic[i], m.roughness[i], m.ior[i] = 1.0, 0.0, 0.05, 1.5
        m.medium.medium_type[i], m.medium.density[i], m.medium.anisotropy[i] = int(MediumType.SCATTER), 0.8, 0.4
        m.medium.color.x[i], m.medium.color.y[i], m.medium.color.z[i] = 0.9, 0.2, 0.1
    return scene


def demo(scene: str, dev) -> Scene:
    """The scene `scene` of `--scene`: a family's demo at depth 4, or a
    media demo (MEDIA_SCENES)."""
    if scene in MEDIA_SCENES:
        return media_demo(dev, MEDIA_SCENES[scene])
    return families.make_family_scene(scene, recursion_depth=DEPTH, device=dev)


_FORWARD, _BACKWARD = mk.forward_library, mk.backward_library  # kernels_of swaps the module's


def mesh_rounds_apart(csrc: Path) -> bool:
    """Whether the tree of sources `csrc` builds the small mesh's K1, K3
    and media-free K2 without FMA contraction, in a library of their own
    (`megakernel_mesh.cu`). An older tree built them contracted, in
    `megakernel_fwd` and `megakernel_bwd`: their frames, counts and records
    differ from this tree's in the last bits, and may tip a path's branch."""
    return (Path(csrc) / "megakernel_mesh.cu").exists()


def forward_library(k: mk.KernelLaunch, csrc: Path):
    """mk.forward_library of the tree of sources `csrc`, an older one's
    small mesh too (mesh_rounds_apart)."""
    if k.backend == "mesh" and not mesh_rounds_apart(csrc):
        return _build.load("megakernel_fwd", csrc=csrc)
    return _FORWARD(k, csrc)


def backward_library(k: mk.KernelLaunch, csrc: Path):
    """mk.backward_library of the tree of sources `csrc`, an older one's
    media-free small mesh too (mesh_rounds_apart)."""
    if k.backend == "mesh" and not k.media and not mesh_rounds_apart(csrc):
        return _build.load("megakernel_bwd", csrc=csrc)
    return _BACKWARD(k, csrc)


def launcher(csrc: Path, k: mk.KernelLaunch, occupancy: bool = False):
    """A call of `csrc`'s K1 with launch `k`'s backend and instantiation,
    into a frame of its own; with `occupancy`, of its K3, returning the
    frame and the counts (int32 [spp, H, W]) as one tensor of int32 bits."""
    lib = forward_library(k, csrc)
    b = mk.BACKENDS[k.backend]
    if k.media:
        entry = getattr(lib, b.media_occupancy if occupancy else b.media_entry)
    else:
        entry = getattr(lib, b.occupancy if occupancy else b.entry)
    out = torch.empty_like(k.out)
    height, width = k.out.shape[:2]
    entered = torch.empty((k.spp, height, width), dtype=torch.int32, device=out.device)
    head = (entered.data_ptr(),) if occupancy else ()
    stream = torch.cuda.current_stream(out.device).cuda_stream

    def run() -> torch.Tensor:
        err = entry(
            k.sv.data_ptr(), k.sv.shape[1], k.keys.data_ptr(), out.data_ptr(), *head, width, height, k.spp,
            k.depth, k.n_lights, k.n_materials, k.flags, *(t.data_ptr() for t in k.extras), *k.counts, stream,
        )
        if err != 0:
            raise RuntimeError(f"launch failed: {lib.pt_error_string(err).decode()}")
        return torch.cat([out.view(torch.int32).reshape(-1), entered.reshape(-1)]) if occupancy else out

    return run


def k6_launcher(csrc: Path, k: mk.KernelLaunch):
    """A call of `csrc`'s march-step counter K6 on launch `k`'s SDF scene,
    into counts of their own: this tree's library of the scene's counts, or
    an older tree's `march_steps`; returns the primary and shadow trips as
    one tensor."""
    if "megakernel_sdf" in _build.per_count_kernels(csrc):
        lib = _build.load("megakernel_sdf", csrc=csrc, counts=k.counts)
    else:
        lib = _build.load("march_steps", csrc=csrc)
    steps = torch.empty((2, HEIGHT, WIDTH), dtype=torch.int32, device=k.out.device)
    stream = torch.cuda.current_stream(steps.device).cuda_stream

    def run() -> torch.Tensor:
        err = lib.pt_march_steps(k.sv.data_ptr(), k.sv.shape[1], steps[0].data_ptr(), steps[1].data_ptr(), WIDTH,
                                 HEIGHT, k.n_lights, k.n_materials, *k.counts, stream)
        if err != 0:
            raise RuntimeError(f"launch failed: {lib.pt_error_string(err).decode()}")
        return steps

    return run


def card_name() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def in_turns(runs: dict, label: str, card: str, log=print) -> dict:
    """Time runs["other"] and runs["this"] (each returns its output) in the
    order other, this, this, other, ROUNDS times, LAUNCHES calls each after
    a warm-up; print and return the means, their ratio, each timing,
    whether the two outputs are bit-equal and, where they are not, how many
    entries differ and, for a float output, by how much at most."""
    theirs, mine = runs["other"](), runs["this"]()
    bit_equal = bool(torch.equal(theirs, mine))
    n_differ = int((theirs != mine).sum())
    max_diff = float((mine.double() - theirs.double()).abs().max()) if mine.is_floating_point() else None
    differ = "" if bit_equal else (f" ({n_differ} of {mine.numel()} entries differ"
                                   + (f", by at most {max_diff:.3e})" if max_diff is not None else ")"))
    times = {"other": [], "this": []}
    for _ in range(ROUNDS):
        for name in ("other", "this", "this", "other"):
            times[name].append(cuda_ms(runs[name], LAUNCHES))
    mean = {name: sum(t) / len(t) for name, t in times.items()}
    log(f"{label} ({card}):")
    for name in ("other", "this"):
        log(f"  {name}: {mean[name]:.4f} ms (each timing: {', '.join(f'{t:.4f}' for t in times[name])})")
    log(f"  this / other = {mean['this'] / mean['other']:.4f}; outputs bit-equal: {bit_equal}{differ}")
    return {"card": card, "other_ms": mean["other"], "this_ms": mean["this"], "ratio": mean["this"] / mean["other"],
            "bit_equal": bit_equal, "differ": n_differ, "entries": mine.numel(), "max_diff": max_diff, "times": times}


_MANGLED = re.compile(r"_Z\w+")


def demangle(names) -> dict:
    """Each mangled name of `names` -> its readable text, as the toolkit's
    cu++filt gives it."""
    names = sorted(set(names))
    tool = Path(_build.find_nvcc()).with_name("cu++filt")
    text = subprocess.run([str(tool)], input="\n".join(names) + "\n", capture_output=True, text=True,
                          check=True).stdout
    return dict(zip(names, text.splitlines()))


def instance(text: str, template: str, n_flags: int):
    """(backend, flag, ...) of the instantiation of `template` named in the
    demangled `text`: its backend type's name without pt:: or its counts
    (pt::Sdf<pt::SdfCounts<1, 1, 1>> -> Sdf), then its last `n_flags` bool
    arguments; None where `text` names none."""
    m = re.search(template + r"<pt::(\w+).*?" + r", ([^,<>]+)" * n_flags + r">(?:\(|\s*$)", text)
    return (m.group(1), *(g.strip() in ("true", "1", "(bool)1") for g in m.groups()[1:])) if m else None


def k1_key(text: str):
    """(backend, COUNT, MEDIA) of an instantiation of K1's template named in
    the demangled `text`, or None."""
    return instance(text, "render_forward_kernel", 2)


def family_of(backend: str) -> str:
    """The scene family of a K1 or K2 backend type's name."""
    for prefix, family in (("Analytical", "analytical"), ("Sdf", "sdf"), ("BigMesh", "bigmesh"), ("Mesh", "mesh")):
        if backend.startswith(prefix):
            return family
    raise ValueError(f"unknown backend {backend}")


def _by_instance(lines: list[str], marker: str, key) -> dict:
    """{i: key(its demangled name)} for each line i of `lines` that holds
    `marker` (None where that line names no instantiation `key` knows)."""
    heads = {i: _MANGLED.search(line) for i, line in enumerate(lines) if marker in line}
    readable = demangle(m.group() for m in heads.values() if m)
    return {i: key(readable[m.group()]) if m else None for i, m in heads.items()}


def _library(csrc: Path, kernel: str, counts) -> Path:
    """The build directory of `csrc` holding `kernel`'s library (for the SDF
    scene's `counts` where the kernel is built for them), built if need be."""
    return _build.build(csrc=csrc, sdf_counts=() if counts is None else (counts,),
                        stems=None if counts is None else (kernel,))


def instantiations(csrc: Path, kernel: str = "megakernel_fwd", key=k1_key, counts=None) -> dict:
    """key(demangled name) -> ptxas's resource lines of that instantiation of the
    template `key` recognises (K1's by default) in `csrc`'s build of
    `kernel` (for the SDF scene's `counts`, a PER_COUNT kernel): its stack
    and spills, its registers."""
    log = _library(csrc, kernel, counts) / f"build_{_build.library_name(kernel, counts)}.log"
    lines = log.read_text().splitlines()
    heads = _by_instance(lines, "Compiling entry", key)
    out, k = {}, None
    for i, line in enumerate(lines):
        if i in heads:
            k = heads[i]
            if k:
                out[k] = []
        elif k and ("registers" in line or "spill" in line):
            out[k].append(line.split(":", 1)[-1].strip())
    return {k: "; ".join(v) for k, v in out.items()}


def sass(csrc: Path, kernel: str = "megakernel_fwd", key=k1_key, counts=None) -> dict:
    """key(demangled name) -> the machine code of that instantiation in `csrc`'s build
    of `kernel`, as cuobjdump lists it without addresses and encodings; {}
    where the toolkit has no cuobjdump."""
    tool = Path(_build.find_nvcc()).with_name("cuobjdump")
    if not tool.exists():
        return {}
    lib = _library(csrc, kernel, counts) / f"lib{_build.library_name(kernel, counts)}.so"
    lines = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True,
                           check=True).stdout.splitlines()
    heads = _by_instance(lines, "Function :", key)
    out, k = {}, None
    for i, line in enumerate(lines):
        if i in heads:
            k = heads[i]
            if k:
                out[k] = []
        elif k:
            code = re.sub(r"/\*[^*]*\*/", "", line).strip()
            if code and not code.startswith("."):
                out[k].append(code)
    return {k: "\n".join(v) for k, v in out.items()}


def tree_csrc(other: Path) -> Path:
    """The kernel sources of the checkout at `other`."""
    return (Path(other) / "pathtracer_tpu_torch" / "csrc").resolve()


def forward_instantiations(csrc: Path, counts=(1, 1, 1)) -> dict:
    """instantiations() of K1's template in every library of `csrc` that
    holds some: `megakernel_fwd`, and where the tree has them the SDF
    scene's for `counts` and the small mesh's (`megakernel_mesh`)."""
    table = instantiations(csrc)
    if "megakernel_sdf" in _build.per_count_kernels(csrc):
        table.update(instantiations(csrc, "megakernel_sdf", counts=counts))
    if mesh_rounds_apart(csrc):
        table.update(instantiations(csrc, "megakernel_mesh"))
    return table


def resources(other: Path, counts=(1, 1, 1), log=print) -> dict:
    """Each instantiation of K1's template in this tree (the SDF scene's
    library for `counts`) and in `other`, with its registers, stack and
    spills: {(family, COUNT, MEDIA): {"this": [...], "other": [...]}}."""
    out = {}
    for tree, csrc in (("this", _build.CSRC), ("other", tree_csrc(other))):
        table = forward_instantiations(csrc, counts)
        for k, v in sorted(table.items()):
            out.setdefault((family_of(k[0]), k[1], k[2]), {}).setdefault(tree, []).append(f"{k[0]}: {v}")
    for (family, count, media), trees in sorted(out.items()):
        log(f"  {family} {'K3' if count else 'K1'}{' MEDIA' if media else ''}: this "
            f"{' | '.join(trees.get('this', []))}; other {' | '.join(trees.get('other', []))}")
    return out


@contextlib.contextmanager
def kernels_of(other: Path):
    """While it lasts, ops/megakernel launches K1, K3 and K2 from `other`'s
    libraries (K2's reduction stays this tree's): a training step of either
    tree, through the port's own code."""
    csrc = tree_csrc(other)
    mk.forward_library = lambda k, c=None: forward_library(k, c or csrc)
    mk.backward_library = lambda k, c=None: backward_library(k, c or csrc)
    try:
        yield
    finally:
        mk.forward_library, mk.backward_library = _FORWARD, _BACKWARD


def pair(others: list[Path], scenes=("analytical",), log=print) -> list[dict]:
    """K1's and K3's launches of each of `others`' trees against this
    one's, in turns, on each scene of `scenes` (a family's demo, or one of
    MEDIA_SCENES)."""
    card = card_name()
    results = []
    for name in scenes:
        scene = demo(name, torch.device("cuda", 0))
        k = mk.prepare_launch(scene, rng.prng_key(5), WIDTH, HEIGHT, 1, VERBATIM)
        for other in others:
            other_csrc = tree_csrc(other)
            for occ in (False, True):
                runs = {"other": launcher(other_csrc, k, occ), "this": launcher(_build.CSRC, k, occ)}
                kernel = ("K3" if occ else "K1") + (" MEDIA" if k.media else "")
                label = f"{kernel} {name} launch at {WIDTH}x{HEIGHT}, depth {k.depth}, spp 1, against {other}"
                results.append({"kernel": kernel, "scene": name, "other": str(other),
                                **in_turns(runs, label, card, log)})
                if occ:  # K3's output: the frame's bits, then the counts
                    frame = k.out.numel()
                    theirs, mine = runs["other"](), runs["this"]()
                    results[-1]["counts_equal"] = bool(torch.equal(theirs[frame:], mine[frame:]))
                    log(f"  counts equal: {results[-1]['counts_equal']}")
            if name == "sdf":
                runs = {"other": k6_launcher(other_csrc, k), "this": k6_launcher(_build.CSRC, k)}
                label = f"K6 sdf launch at {WIDTH}x{HEIGHT} against {other} (outputs: the trips)"
                results.append({"kernel": "K6", "scene": name, "other": str(other), **in_turns(runs, label, card, log)})
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--other", required=True, nargs="+", type=Path, help="root of each other checkout")
    ap.add_argument("--scene", nargs="+", default=["analytical"], choices=(*families.FAMILIES, *MEDIA_SCENES),
                    help="the demo scenes whose backends to time")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k1_pair needs a CUDA device")
    card = card_name()
    results = pair(args.other, args.scene)
    for other in args.other:
        print(f"K1's and K3's instantiations against {other}:")
        resources(other)
    print(card)
    print(json.dumps(results if len(results) > 1 else results[0]))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
