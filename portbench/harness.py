"""One run of one cell: set-up, the measured window, the correctness check
against the plain reference, the metrics, and the result line.

`run()` is what `run.py` calls on the card. The tests call it too, on the
CPU at a small size (`device=`, `size=`), where the program renders
through its plain version; a result from such a run is never a device
metric.
"""

from __future__ import annotations

import gc
import os
import resource
import subprocess
import sys
import time

import torch

from . import check, drivers, spec
from . import traffic as gen
from .reference import scenes
from .reference import work as ref_work
from .roofline import bound_ms
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
    counts for the key's frame (each of spp samples' keys)."""
    ref = cell.config["scene"] if cell.traffic["kind"] == "frames" else cell.config["train"]["start"]
    scene = scenes.scene_from_dict(ref, device=device)
    family = ref["family"]
    keys = [key] if spp == 1 else list(gen.rng.split(key, spp))
    work = {}
    for k in keys:
        for name, v in ref_work.count_work(scene, family, k, width, height).items():
            work[name] = work.get(name, 0) + v
    pixels, scalars = width * height, scene_scalars(scene)
    return {"k1": bound_ms("k1", family, work, pixels, scalars), "k2": bound_ms("k2", family, work, pixels, scalars),
            "work": work}


def run(cell_name: str, seed: int, seconds: float, trace: bool, t_start: float, root=spec.ROOT, device=None,
        size=None) -> tuple[dict, list[str]]:
    """(the result line's object, the lines for standard error)."""
    t = log("set-up: python, torch and the benchmark imported", t_start)
    cell = spec.resolve(cell_name, root)
    gen.check_traffic(cell.traffic, drivers.DRIVERS)
    if device is None:
        device = card(cell.chips)
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.init()
        t = log("set-up: the card's context", t)
    spans = Spans(annotate=trace)
    driver = drivers.DRIVERS[cell.traffic["kind"]](cell, seed, device, spans, size)
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
    if mix["kind"] == "frames":
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
        print(f"portbench: work {bounds['work']}, bounds k1 {bounds['k1']!r} ms, k2 {bounds['k2']!r} ms",
              file=sys.stderr)
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
           "count": cell.chips, "memory_peak_bytes": int(memory_peak)}
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
