"""One run of one cell: set-up, the measured window, the correctness check
against the plain reference, the metrics, and the result line.

`run()` is what `run.py` calls on the card; a cell on several cards runs
as one rank a card (`ranks.py`), the others `rank_window`. The tests call
it too, on the CPU at a small size (`device=`, `size=`, `ranks=`, gloo
ranks), where the program renders through its plain version; a result
from such a run is never a device metric.
"""

from __future__ import annotations

import gc
import os
import resource
import subprocess
import sys
import time
from pathlib import Path

import torch

from . import check, faults, roofline, spec
from . import ranks as shard
from . import traffic as gen
from .reference import scenes
from .reference import work as ref_work
from .tracing import Profiler, Run, Spans, log, read_counter

LABEL_SECONDS, TRACE_SECONDS = 1.0, 2.0  # the traced parts of a --trace 1 window (tracing.Profiler)
FORBIDDEN = ("jax", "jaxlib", "flax", "pathtracer_tpu")


class NoCard(SystemExit):
    pass


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, the part before the first dot
    taken whole, is JAX's, its libraries' or the JAX package's."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def card(chips: int) -> torch.device:
    """The first card; a machine with no CUDA or fewer cards than the cell
    asks for ends the run."""
    if not torch.cuda.is_available():
        raise NoCard("portbench: CUDA is not available; the benchmark runs only on the card")
    if torch.cuda.device_count() < chips:
        raise NoCard(f"portbench: the cell asks for {chips} cards, this machine has {torch.cuda.device_count()}")
    return torch.device("cuda", 0)


def power_limit() -> float | None:
    """The card's power limit in W (nvidia-smi), or None."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=20, check=True).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def cpu_seconds() -> float:
    r = resource.getrusage(resource.RUSAGE_SELF)
    return r.ru_utime + r.ru_stime


def host_line(cpu_s: float, window_s: float) -> str:
    """The share of one core this process had over the window, with the
    CPU's model and clocks: what to compare between runs when the host,
    not the card, paces a cell."""
    model, mhz = "?", []
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name") and model == "?":
                    model = line.split(":", 1)[1].strip()
                elif line.startswith("cpu MHz"):
                    mhz.append(float(line.split(":", 1)[1]))
    except (OSError, ValueError):
        pass
    clocks = f"; MHz {min(mhz):.0f}-{max(mhz):.0f}" if mhz else ""
    return (f"portbench: host cpu {cpu_s / window_s:.3f} of a core over the window; {os.cpu_count()} cpus, "
            f"{len(os.sched_getaffinity(0))} ours, {model}{clocks}")


def counter_paths(cell: spec.Cell) -> list[str]:
    return sorted({p for _, module in cell.per_layer for p in getattr(module, "COUNTERS", ())})


def scene_scalars(scene) -> int:
    return sum(t.numel() for t in scenes.named_leaves(scene).values())


def reference_bounds(cell: spec.Cell, key, device, width: int, height: int, spp: int) -> dict:
    """The K1 and K2 bounds, ms, of one launch on the work the reference
    counts for the key's frame (each of spp samples' keys); none for a
    family without frozen operation counts (`roofline.counts_of`)."""
    ref = cell.config["scene"] if cell.kind.COMPARES == "frames" else cell.config["train"]["start"]
    family = ref["family"]
    if roofline.counts_of(family) is None:
        return {}
    scene = scenes.scene_from_dict(ref, device=device)
    keys = [key] if spp == 1 else list(gen.rng.split(key, spp))
    work = {}
    for k in keys:
        for name, v in ref_work.count_work(scene, family, k, width, height).items():
            work[name] = work.get(name, 0) + v
    pixels, scalars = width * height, scene_scalars(scene)
    return {"k1": roofline.bound_ms("k1", family, work, pixels, scalars),
            "k2": roofline.bound_ms("k2", family, work, pixels, scalars), "work": work}


def run(cell_name: str, seed: int, seconds: float, trace: bool, t_start: float, root=spec.ROOT, device=None,
        size=None, ranks=None, group=None) -> tuple[dict, list[str]]:
    """(the result line's object, the lines for standard error). A cell on
    several cards (`ranks`, by default its chips) runs as that many ranks,
    this process rank 0: the others `group` (`ranks.Ranks`, spawned by the
    caller with `ranks.window_job`'s job), or spawned here."""
    t = log("set-up: python, torch and the benchmark imported", t_start)
    cell = spec.resolve(cell_name, root)
    gen.check_traffic(cell.traffic, spec.kinds(root))
    if device is None:
        device = card(cell.chips)
    device = torch.device(device)
    world = cell.chips if ranks is None else ranks
    if world == 1:
        return measured(cell, seed, seconds, trace, t_start, t, device, size)
    if group is None:
        _, job = shard.window_job(cell_name, seed, seconds, root, size, faults.active())
        group = shard.Ranks(world, job, device.type)
    with group:
        return measured(cell, seed, seconds, trace, t_start, t, device, size, group)


def measured(cell: spec.Cell, seed: int, seconds: float, trace: bool, t_start: float, t: float, device, size,
             group=None) -> tuple[dict, list[str]]:
    """`run`'s set-up, window, comparison and metrics, as rank 0 where
    `group` (`ranks.Ranks`) holds the other ranks."""
    if group is not None:
        device = group.join()
        t = log(f"set-up: {group.world} ranks joined", t)
    if device.type == "cuda":
        torch.cuda.init()
        t = log("set-up: the card's context", t)
    spans = Spans(annotate=trace)
    driver = cell.kind.DRIVER(cell, seed, device, spans, size)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)  # once the driver's tensors made the allocator
    driver.setup()
    setup_s = time.perf_counter() - t_start
    t = log("set-up", t_start)

    paths = counter_paths(cell) if trace else []
    before = {p: read_counter(p) for p in paths}
    profiler = Profiler(min(LABEL_SECONDS, seconds / 4), min(TRACE_SECONDS, seconds / 2), device.type == "cuda") \
        if trace else None
    if profiler is not None:
        profiler.start()
    cpu_s = cpu_seconds()
    driver.window(seconds, profiler)
    print(host_line(cpu_seconds() - cpu_s, driver.window_s), file=sys.stderr)
    t = log(f"window ({driver.units()} units)", t)
    traces = profiler.finish(driver.units()) if profiler is not None else {}
    traced = traces.get("device")
    if traces:
        t = log(", ".join(f"{k}: {len(v.ops)} device operations, {len(v.host)} host ranges, {v.units} units"
                          for k, v in traces.items()), t)
    counters = {p: read_counter(p) - before[p] for p in paths}
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    if group is not None:
        memory_peak = group.close(memory_peak, len(forbidden_modules()))
        t = log("the ranks' peaks gathered, the group torn down, the ranks joined", t)
    e2e = {} if trace else driver.end_to_end()

    mix = cell.traffic
    width, height = size or (int(mix["width"]), int(mix["height"]))
    outputs, first, keep = driver.outputs(), None, None
    if "grazing" in cell.checks:
        first = check.FirstStep(cell.config, mix, seed, device, width, height, float(cell.checks["grazing"]))
        outputs["train"]["masked_grad"], keep, counts = driver.masked_grad(first)
        print(f"portbench: reading pixels left out of grad_gap_masked {counts}", file=sys.stderr)
    driver.free()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    if cell.kind.COMPARES == "frames":
        numbers = check.compare_frames(outputs["frames"], check.reference_scene(cell.config, device), width, height,
                                       int(mix["spp"]))
    else:
        want = check.TrainReference(cell.config, mix, int(cell.checks["steps"]), seed, device, size=size,
                                    target=first.target if first is not None else None)
        if first is not None:
            want.masked_grad = first.masked_grad(keep)
        numbers = check.compare_train(outputs["train"], want)
        for line in check.train_details(outputs["train"], want):
            print(f"portbench: {line}", file=sys.stderr)
    correct, failed, checks = check.verdict(numbers, cell.checks["limits"])
    for name, value in numbers.items():
        if name not in checks:
            print(f"portbench: reading {name} {value!r} (not held)", file=sys.stderr)
    t = log("reference and comparison", t)

    metrics = {}
    if trace:
        bounds = reference_bounds(cell, driver.work_key(), device, width, height, int(mix["spp"]))
        if bounds:
            print(f"portbench: work {bounds['work']}, bounds k1 {bounds['k1']!r} ms, k2 {bounds['k2']!r} ms",
                  file=sys.stderr)
        else:
            print("portbench: no frozen operation counts for the scene's family: no roofline", file=sys.stderr)
        r = Run(cell, driver.units(), driver.window_s, spans, counters, traced, driver.latency_ms, bounds)
        for entry, module in cell.per_layer:
            value = module.read(r)
            if value is not None:
                metrics[entry["name"]] = {"value": float(value), "unit": entry["unit"]}
    else:
        e2e["setup_s"] = setup_s
        for entry in cell.end_to_end:
            metrics[entry["name"]] = {"value": float(e2e[entry["name"]]), "unit": entry["unit"]}

    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1 if group is None else group.world, "memory_peak_bytes": int(memory_peak)}
    if device.type == "cuda":
        dev["power_limit_w"] = power_limit()
    result = {"correct": bool(correct), "attempted": driver.units(), "failed": failed, "metrics": metrics,
              "device": dev}
    if traced is not None:
        dev["busy_s"], dev["window_s"] = traced.busy_s, traced.window_s
        labels = traces.get("labels", traced)
        result["breakdown"] = {"device_ops": traced.device_ops(), "idle_gaps": labels.idle_gaps()}
        log("breakdown", t)
    result["checks"] = checks
    lines = [f"check {name}: {c['value']!r} (limit {c['limit']!r})" for name, c in checks.items()]
    return result, lines


def rank_window(job: dict) -> int:
    """A rank other than 0 of a run (`ranks.child`): its driver's set-up and
    window in lock step with rank 0's, then its memory peak and forbidden
    modules to rank 0; 3 where it loaded one."""
    cell = spec.resolve(job["cell"], Path(job["root"]))
    device = shard.join_group(job["rank"], job["world"], job["init_method"], job["device"])
    size = tuple(job["size"]) if job["size"] else None
    driver = cell.kind.DRIVER(cell, job["seed"], device, Spans(), size)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    driver.setup()
    driver.window(job["seconds"])
    loaded = forbidden_modules()
    shard.gather(torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0, len(loaded), device)
    shard.leave()
    if loaded:
        print(f"portbench: rank {job['rank']}: JAX or the JAX package is loaded: {', '.join(loaded)}",
              file=sys.stderr)
        return 3
    return 0
