"""Where one training step's time goes on the card.

For each family given, one `inverse.paired_step` at 1920x1080, depth 4,
spp 1 (two K1 renders, one K2 backward, the paired loss, Adam) on its
trainer's scene: the analytical and SDF demos of `recover_demo`, the
mesh's vertex recovery of `inverse_render` (`inverse.mesh_start_scene`).
Prints the step's time by CUDA events and by the host clock (10 steps
after a warm-up), then runs 5 steps under `torch.profiler` and prints the
device time a step, the share of the step the card idles, and the tables
of kernels by device time and of host calls by host time; with `--trace
DIR`, a Chrome trace per family there. The card's name and power limit
come before the last line, which is one JSON object of the numbers.

Usage:
  python -m pathtracer_tpu_torch.tools.profile_step [--scene analytical mesh] [--trace DIR]
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from ..integrator import inverse
from ..integrator.tracer import VERBATIM
from ..models import families
from ..ops import rng
from ..utils.timing import cuda_ms
from .k1_pair import DEPTH, HEIGHT, WIDTH, card_name

STEPS, PROFILED = 10, 5


def make_step(family: str, dev):
    """One paired_step of `family`'s trainer at 1080p, as a call."""
    if family == "mesh":
        true = families.make_family_scene("mesh", recursion_depth=DEPTH, device=dev)
        start, select, projection = inverse.mesh_start_scene(true), inverse.MESH_SELECT, None
    else:
        true, start = inverse.demo_scenes(DEPTH, dev, family)
        select, projection = inverse.DEMO_SELECTS[family], inverse.PROJECTIONS[family]
    render = inverse.make_renderer("megakernel", WIDTH, HEIGHT, 1, VERBATIM)
    with torch.no_grad():
        target = render(true, rng.prng_key(8))
    train, rebuild, _ = inverse.select_leaves(start, select)
    opt = inverse.make_adam(train, 3e-2)
    return lambda: inverse.paired_step(train, rebuild, projection, opt, render, target, rng.prng_key(7))


def profile_step(family: str, dev, trace: str | None = None, log=print) -> dict:
    step = make_step(family, dev)
    event_ms = cuda_ms(step, STEPS, warmup=2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(STEPS):
        step()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / STEPS
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILED):
            step()
        torch.cuda.synchronize()
        profiled_ms = (time.perf_counter() - t0) * 1e3 / PROFILED
    events = prof.key_averages()
    device_ms = sum(e.self_device_time_total for e in events if e.device_type == DeviceType.CUDA) / 1e3 / PROFILED
    syncs = sum(e.count for e in events if e.key == "cudaStreamSynchronize") / PROFILED
    log(f"{family} step at {WIDTH}x{HEIGHT}, depth {DEPTH}, spp 1: {event_ms:.3f} ms (CUDA events), "
        f"{host_ms:.3f} ms (host clock); under the profiler {profiled_ms:.3f} ms, of which the device is busy "
        f"{device_ms:.3f} ms (idle {1 - device_ms / profiled_ms:.1%}), {syncs:.0f} stream syncs a step")
    log(events.table(sort_by="self_cuda_time_total", row_limit=12, max_name_column_width=60))
    log(events.table(sort_by="self_cpu_time_total", row_limit=12, max_name_column_width=60))
    if trace:
        os.makedirs(trace, exist_ok=True)
        prof.export_chrome_trace(os.path.join(trace, f"step_{family}.json"))
    return {"scene": family, "event_ms": event_ms, "host_ms": host_ms, "profiled_ms": profiled_ms,
            "device_ms": device_ms, "syncs_per_step": syncs}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--scene", nargs="+", default=["analytical", "mesh"], choices=tuple(inverse.DEMO_SELECTS) + (
        "mesh",), help="the trainers to profile")
    ap.add_argument("--trace", default=None, help="directory for a Chrome trace per family")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_step needs a CUDA device")
    dev = torch.device("cuda", 0)
    results = [profile_step(family, dev, args.trace) for family in args.scene]
    print(card_name())
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
