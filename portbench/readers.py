"""The fixed readers a per-layer metric's file (`metrics/<name>.py`) calls
with the `tracing.Run` it is given. Each returns None where the run has
nothing to read (no trace, no such kernel, no such span), and the harness
then leaves the metric out of the result line.
"""

from __future__ import annotations

import math


def idle_share(run) -> float | None:
    """% of the traced window in which no operation ran on the device."""
    t = run.trace
    if t is None or not t.ops or not t.window_s:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def kernel_ms(run, pattern: str, per: str = "unit") -> float | None:
    """Device ms of the kernels whose name matches `pattern` in the traced
    window, a launch (per="launch") or a frame or step (per="unit")."""
    t = run.trace
    if t is None:
        return None
    us, launches = t.kernel_us(pattern)
    n = launches if per == "launch" else t.units
    return us / 1e3 / n if launches and n else None


def roofline(run, bound: str, pattern: str, per: str = "unit") -> float | None:
    """% of the frozen bound (`run.bounds[bound]`, ms of one launch: one
    frame's K1, one step's K2) over the matching kernels' device ms."""
    ms = kernel_ms(run, pattern, per)
    if ms is None or bound not in run.bounds:
        return None
    return 100.0 * run.bounds[bound] / ms


def span_ms(run, name: str) -> float | None:
    """Host ms of the benchmark's span `name`, a call, over the window."""
    n = run.spans.count.get(name, 0)
    return run.spans.total[name] * 1e3 / n if n else None


def counter_per_unit(run, path: str) -> float | None:
    """A program counter's increase over the window, a frame or step."""
    if path not in run.counters or not run.units:
        return None
    return run.counters[path] / run.units


def latency_p95(run) -> float | None:
    """The 95th percentile, by nearest rank, of the frames' latencies, ms."""
    lat = sorted(run.latency_ms)
    return lat[max(0, math.ceil(0.95 * len(lat)) - 1)] if lat else None
