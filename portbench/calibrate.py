"""The readings a cell's correctness limits are set from, on the card at
the cell's own size, in one process:

    python3 portbench/calibrate.py --workload <cell> --seeds 12 --first-seed <n> [--control 3] [--faults 3]

- the program's numbers on `--seeds` seeds (a short window each for the
  frames cells; the checked first steps for the training cells): the
  lower readings;
- the control's on the first `--control` seeds: the reference put in the
  program's place and computed in bfloat16, the precision below the
  configuration's float32 (frames: the first frames of a window, the
  running mean kept in bfloat16 too; training: the checked steps);
- for a training cell, each fault of `faults.py` planted in the program on
  the first `--faults` seeds.

A cell on several cards runs the program's part as one rank a card in one
process group (`ranks.py`, this process rank 0; every rank runs each seed
and fault in turn and rank 0 keeps the outputs), then the references and
comparisons on rank 0's card once the group is torn down (`--device cpu
--size WxH`: with gloo ranks on the CPU).

A training cell whose check file gives `grazing` also takes the first
gradient over the pixels that `check.FirstStep.keep_of` keeps, on every
side.

One JSON line a reading ({"seed", "what", "numbers"}), then one with each
number's largest sound reading and smallest control and fault readings.
The benchmark's own runs never run this.
"""

import argparse
import gc
import json
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def control_frames(cell, seed: int, device, frames: int, size=None) -> dict:
    """The control's frames numbers: the first `frames` frames of a window
    rendered and accumulated by the reference in bfloat16."""
    from portbench import check
    from portbench import traffic as gen

    t = cell.traffic
    (width, height), spp = size or (int(t["width"]), int(t["height"])), int(t["spp"])
    low = check.reference_scene(cell.config, device, torch.bfloat16)
    ref = check.reference_scene(cell.config, device)
    keys = gen.frame_keys(seed)
    pixels = torch.zeros((height, width, 4), dtype=torch.bfloat16, device=device)
    n = torch.zeros((), dtype=torch.bfloat16, device=device)
    records = []
    for i in range(frames):
        key = next(keys)
        frame = check.render_reference(low, key, width, height, spp)
        w = 1.0 / (n + 1.0)
        new, n = pixels * (1.0 - w) + frame * w, n + 1
        records.append((i, key, frame, pixels, new))
        pixels = new
    return check.compare_frames(records, ref, width, height, spp)


def first_step(cell, seed: int, device, size=None, dtype=torch.float32):
    """The reference's first step (`check.FirstStep`) for a training cell
    whose check file gives `grazing`, else None."""
    from portbench import check

    if "grazing" not in cell.checks:
        return None
    t = cell.traffic
    width, height = size or (int(t["width"]), int(t["height"]))
    return check.FirstStep(cell.config, t, seed, device, width, height, float(cell.checks["grazing"]), dtype)


def control_numbers(cell, seed: int, device, want=None, size=None, first=None) -> dict:
    """The control's numbers for one seed: the reference in bfloat16 put in
    the program's place (frames: as many frames as a run compares, from the
    window's first; training: the checked steps, against `want`, and the
    first gradient over the pixels `first` keeps of its renders)."""
    from portbench import check

    if cell.kind.COMPARES == "frames":
        return control_frames(cell, seed, device, int(cell.checks["sample"]) + 2, size)
    low = check.TrainReference(cell.config, cell.traffic, int(cell.checks["steps"]), seed, device, torch.bfloat16,
                               size)
    got = {"names": low.names, "losses": low.losses, "first_grad": low.first_grad, "change": low.change}
    if first is not None:
        low_first = first_step(cell, seed, device, size, torch.bfloat16)
        keep, counts = first.keep_of(low_first.a, low_first.b, low_first.target)
        print(f"seed {seed}: control: pixels left out {counts}", file=sys.stderr)
        got["masked_grad"] = low_first.masked_grad(keep)
        want.masked_grad = first.masked_grad(keep)
    for line in check.train_details(got, want):
        print(f"seed {seed}: control: {line}", file=sys.stderr)
    return check.compare_train(got, want)


def free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def program_outputs(cell, seed: int, device, seconds: float, size=None) -> dict:
    """The program's outputs for one seed: set-up and (frames) a short
    window, as a run makes them; the driver freed."""
    from portbench.tracing import Spans

    driver = cell.kind.DRIVER(cell, seed, device, Spans(), size)
    driver.setup()
    if cell.kind.COMPARES == "frames":
        driver.window(seconds)
    out = driver.outputs()
    driver.free()
    free(device)
    return out


def program_numbers(cell, seed: int, device, seconds: float, want=None, size=None, first=None, out=None) -> dict:
    """The program's numbers for one seed (its outputs `out`, or taken
    here), compared as a run compares them."""
    from portbench import check
    from portbench.tracing import Spans

    if first is not None:
        driver = cell.kind.DRIVER(cell, seed, device, Spans(), size)
        driver.setup()
        out = driver.outputs()
        out["train"]["masked_grad"], keep, counts = driver.masked_grad(first)
        print(f"seed {seed}: pixels left out {counts}", file=sys.stderr)
        want.masked_grad = first.masked_grad(keep)
        driver.free()
        free(device)
    elif out is None:
        out = program_outputs(cell, seed, device, seconds, size)
    t = cell.traffic
    if cell.kind.COMPARES == "frames":
        width, height = size or (int(t["width"]), int(t["height"]))
        return check.compare_frames(out["frames"], check.reference_scene(cell.config, device), width, height,
                                    int(t["spp"]))
    for line in check.train_details(out["train"], want):
        print(f"seed {seed}: {line}", file=sys.stderr)
    return check.compare_train(out["train"], want)


def rank_outputs(cell, items, device, size=None) -> dict:
    """Every rank of a cell on several cards, in the same order: each
    (seed, what) of `items` through set-up, `what` a fault planted or
    "sound"; {(seed, what): outputs}."""
    import contextlib

    from portbench import faults

    held = {}
    for seed, what in items:
        with faults.planted(cell.traffic["kind"], what) if what != "sound" else contextlib.nullcontext():
            held[(seed, what)] = program_outputs(cell, seed, device, 0.0, size)
    return held


def rank_items(job: dict) -> int:
    """A rank other than 0 of calibrate's group (`ranks.child`)."""
    from pathlib import Path

    from portbench import harness, spec
    from portbench import ranks as shard

    cell = spec.resolve(job["cell"], Path(job["root"]))
    device = shard.join_group(job["rank"], job["world"], job["init_method"], job["device"])
    rank_outputs(cell, [tuple(i) for i in job["items"]], device, tuple(job["size"]) if job["size"] else None)
    shard.gather(0, len(harness.forbidden_modules()), device)
    shard.leave()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first-seed", type=int, default=4_000_000_001)
    ap.add_argument("--seed-list", default=None, help="comma-separated seeds instead of --first-seed and --seeds")
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--faults", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=1.0, help="each frames window")
    ap.add_argument("--device", default="cuda", help="cpu: a rehearsal with --size, no reading of the card")
    ap.add_argument("--size", default=None, help="WxH instead of the traffic's, for a rehearsal")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from portbench import check, faults, spec
    from portbench import ranks as shard

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("calibrate reads the card; CUDA is not available")
    size = tuple(int(x) for x in args.size.split("x")) if args.size else None
    cell = spec.resolve(args.workload)
    kind, train = cell.traffic["kind"], cell.kind.COMPARES == "train"
    readings = {"sound": [], "control": [], **{f: [] for f in faults.faults_of(kind)}}

    def emit(seed, what, numbers, t0):
        readings[what].append(numbers)
        print(json.dumps({"seed": seed, "what": what, "numbers": numbers, "seconds": time.perf_counter() - t0}),
              flush=True)

    seeds = [int(x) for x in args.seed_list.split(",")] if args.seed_list else \
        [args.first_seed + j for j in range(args.seeds)]
    held = {}  # (seed, what) -> outputs, of a cell on several cards
    if cell.chips > 1:
        if "grazing" in cell.checks or not train:
            raise ValueError("calibrate runs a cell on several cards for a training comparison without grazing")
        items = [(s, "sound") for s in seeds] + [(s, f) for s in seeds[:args.faults] for f in faults.faults_of(kind)]
        job = dict(job="calibrate", cell=args.workload, kind=kind, root=ROOT, size=size, items=items)
        t0 = time.perf_counter()
        with shard.Ranks(cell.chips, job, device.type) as group:
            held = rank_outputs(cell, items, group.join(), size)
            group.close(0, 0)
        print(f"{cell.chips} ranks: {len(items)} set-ups in {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    for j, seed in enumerate(seeds):
        t0 = time.perf_counter()
        want = first = None
        if train:
            first = first_step(cell, seed, device, size)
            want = check.TrainReference(cell.config, cell.traffic, int(cell.checks["steps"]), seed, device, size=size,
                                        target=first.target if first is not None else None)
        emit(seed, "sound", program_numbers(cell, seed, device, args.seconds, want, size, first,
                                            held.get((seed, "sound"))), t0)
        if j < args.control:
            t0 = time.perf_counter()
            emit(seed, "control", control_numbers(cell, seed, device, want, size, first), t0)
        if train and j < args.faults:
            for fault in faults.faults_of(kind):
                t0 = time.perf_counter()
                if held:
                    emit(seed, fault, program_numbers(cell, seed, device, args.seconds, want, size,
                                                      out=held[(seed, fault)]), t0)
                    continue
                with faults.planted(kind, fault):
                    emit(seed, fault, program_numbers(cell, seed, device, args.seconds, want, size, first), t0)
        free(device)
    summary = {what: {k: (max if what == "sound" else min)(r[k] for r in rs) for k in rs[0]}
               for what, rs in readings.items() if rs}
    print(json.dumps({"workload": args.workload, "summary": summary}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
