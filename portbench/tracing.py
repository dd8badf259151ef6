"""What a run records besides its end-to-end metrics: the host spans the
benchmark puts around its calls into the program, snapshots of the
program's counters, and, with `--trace 1`, a torch.profiler (CUPTI) trace
of part of the window, reduced to device time by kernel, the device's busy
time and the idle gaps by what the host was doing.

The spans are the benchmark's own (host clock, `time.perf_counter`); each
is also a `record_function` range, so the trace shows where the host was
while the device idled. A per-layer metric reads these through its reader
(`metrics/<name>.py`): `Run` below is what a reader gets.
"""

from __future__ import annotations

import contextlib
import importlib
import json
import os
import re
import sys
import tempfile
import time
from collections import defaultdict
from typing import NamedTuple

import torch

TOP = 10  # entries of each breakdown list


def log(what: str, t0: float) -> float:
    """A phase's seconds on standard error; returns the clock."""
    now = time.perf_counter()
    print(f"portbench: {what} {now - t0:.3f} s", file=sys.stderr, flush=True)
    return now


class Spans:
    """Host-clock spans by name: total seconds and count."""

    def __init__(self, annotate: bool = False):
        self.annotate = annotate
        self.reset()

    def reset(self) -> None:
        self.total = defaultdict(float)
        self.count = defaultdict(int)

    @contextlib.contextmanager
    def span(self, name: str):
        ctx = torch.profiler.record_function(f"portbench.{name}") if self.annotate else contextlib.nullcontext()
        t = time.perf_counter()
        with ctx:
            yield
        self.total[name] += time.perf_counter() - t
        self.count[name] += 1


def read_counter(path: str):
    """A program counter by its dotted path 'module:attr.attr' (e.g.
    'pathtracer_tpu_torch.ops.megakernel:render_frame_megakernel.launches')."""
    module, _, attrs = path.partition(":")
    obj = importlib.import_module(module)
    for a in attrs.split("."):
        obj = getattr(obj, a)
    return obj


class Kernel(NamedTuple):
    name: str
    start_us: float
    dur_us: float


class Trace(NamedTuple):
    """The traced part of a window: its device operations (kernels, copies,
    sets), its length, and the units (frames or steps) it held."""

    ops: list  # [Kernel], sorted by start
    window_s: float
    units: int
    host: list  # [(name, start_us, end_us, thread)] of the host's annotated ranges and operators

    @property
    def busy_s(self) -> float:
        """Seconds in which an operation ran on the device: the union of the
        operations' intervals."""
        busy, end = 0.0, -float("inf")
        for k in self.ops:
            s, e = k.start_us, k.start_us + k.dur_us
            if e > end:
                busy += e - max(s, end)
                end = e
        return busy / 1e6

    def kernel_us(self, pattern: str) -> tuple[float, int]:
        """Device microseconds and launches of the kernels whose name
        matches the regular expression `pattern`."""
        rx = re.compile(pattern)
        hits = [k.dur_us for k in self.ops if rx.search(k.name)]
        return sum(hits), len(hits)

    def device_ops(self) -> list:
        """[name, seconds] of the TOP device operations by total time."""
        by = defaultdict(float)
        for k in self.ops:
            by[k.name] += k.dur_us / 1e6
        return [[n, s] for n, s in sorted(by.items(), key=lambda kv: -kv[1])[:TOP]]

    def idle_gaps(self) -> list:
        """[what the host was doing, seconds] of the TOP labels by idle
        time: each gap between device operations goes to the innermost host
        range open at its middle (an operator or a runtime call), under the
        outermost benchmark span open then."""
        gaps, end = [], None
        for k in self.ops:
            if end is not None and k.start_us > end:
                gaps.append(((end + k.start_us) / 2, (k.start_us - end) / 1e6))
            end = k.start_us + k.dur_us if end is None else max(end, k.start_us + k.dur_us)
        by = defaultdict(float)
        for (_, seconds), label in zip(gaps, host_labels(self.host, [t for t, _ in gaps])):
            by[label] += seconds
        return [[n, s] for n, s in sorted(by.items(), key=lambda kv: -kv[1])[:TOP]]


def host_labels(host: list, times: list) -> list:
    """For each of the sorted `times`, 'outer > inner': the outermost
    benchmark span and the innermost host range open then, over every
    thread (a thread's ranges nest, so each keeps a stack); one sweep."""
    stacks = defaultdict(list)  # tid -> [(end, name, start)], outermost first
    events = sorted(host, key=lambda h: h[1])
    out, j = [], 0
    for t in times:
        while j < len(events) and events[j][1] <= t:
            name, start, stop, tid = events[j]
            st = stacks[tid]
            while st and st[-1][0] <= start:
                st.pop()
            st.append((stop, name, start))
            j += 1
        inner, outer = None, None
        for st in stacks.values():
            while st and st[-1][0] < t:
                st.pop()
            if st and (inner is None or st[-1][2] > inner[2]):
                inner = st[-1]
            for end, name, _ in st:
                if end >= t and name.startswith("portbench."):
                    outer = name
                    break
        if inner is None:
            out.append("host: outside every range")
        elif outer is None or outer == inner[1]:
            out.append(inner[1])
        else:
            out.append(f"{outer} > {inner[1]}")
    return out


def parse_chrome_trace(path: str) -> tuple[list, list]:
    """(device operations [Kernel], host ranges [(name, start, end, thread)]) of a
    torch.profiler Chrome trace."""
    with open(path) as f:
        events = json.load(f)
    events = events.get("traceEvents", events) if isinstance(events, dict) else events
    ops, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat", "")
        if cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            ops.append(Kernel(e["name"], float(e["ts"]), float(e["dur"])))
        elif cat in ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver"):
            host.append((e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]), e.get("tid", 0)))
    ops.sort(key=lambda k: k.start_us)
    return ops, host


class Profiler:
    """torch.profiler over two parts at the start of a window. First
    `label_s` seconds with CPU and CUDA activity: the host's operators and
    the benchmark's spans, which say what the host did while the device
    idled, but which slow the host. Then `seconds` with CUDA activity
    alone, a few microseconds a launch: the device's busy time and its
    operations by name. Each part ends with the device drained, so it holds
    every operation of its frames or steps."""

    def __init__(self, label_s: float, seconds: float, cuda: bool):
        cpu, gpu = torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA
        self.parts = [("labels", label_s, [cpu, gpu] if cuda else [cpu]),
                      ("device", seconds, [gpu] if cuda else [cpu])]
        self.cuda = cuda
        self.traces = {}
        self.part = -1
        self.prof = self.t0 = None
        self.units0 = 0

    def _begin(self, units: int) -> None:
        self.part += 1
        if self.part < len(self.parts):
            self.prof = torch.profiler.profile(activities=self.parts[self.part][2])
            self.prof.start()
            self.t0, self.units0 = time.perf_counter(), units

    def _end(self, units: int) -> None:
        if self.cuda:
            torch.cuda.synchronize()
        length = time.perf_counter() - self.t0
        self.prof.stop()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            self.prof.export_chrome_trace(path)
            ops, host = parse_chrome_trace(path)
        self.traces[self.parts[self.part][0]] = Trace(ops, length, units - self.units0, host)
        self.prof = None

    def start(self) -> None:
        self._begin(0)

    def tick(self, units: int) -> bool:
        """After a frame or step (`units` done in the window): ends the
        running part once its time has passed and starts the next; True
        when the labelling part has just ended, so the caller drops what it
        timed under it."""
        if self.prof is None or time.perf_counter() - self.t0 < self.parts[self.part][1]:
            return False
        self._end(units)
        labelled = self.parts[self.part][0] == "labels"
        self._begin(units)
        return labelled

    def finish(self, units: int) -> dict:
        """{"labels": Trace, "device": Trace} of the parts that ran."""
        if self.prof is not None:
            self._end(units)
        return self.traces


class Run(NamedTuple):
    """What a per-layer metric's reader gets: the cell, the window's
    spans and counters, the trace, and the work the reference counted."""

    cell: object  # spec.Cell
    units: int  # frames or steps completed in the window
    window_s: float
    spans: Spans
    counters: dict  # path -> value at the window's end minus at its start
    trace: Trace | None  # the CUDA-only part
    latency_ms: list  # each frame's latency, those timed under the labelling part left out
    bounds: dict  # "k1" / "k2" -> the bound's ms of one launch, from the reference's counts
