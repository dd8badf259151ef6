"""Trainer: host ms a step of the program's span `step_forward`
(integrator/inverse.paired_step: zero_grad, rebuild, projection, both
renders, the paired loss, as enqueued; any wait for the card in them).
The span's totals cover the whole window, its labelled second (the CPU
profiler's, which slows the host) included."""
import importlib

from portbench.tracing import read_counter

importlib.import_module("pathtracer_tpu_torch.integrator.inverse")  # which makes the span
SPAN = "pathtracer_tpu_torch.utils.metrics:SPANS.step_forward"
try:
    read_counter(SPAN)
    COUNTERS = (f"{SPAN}.seconds", f"{SPAN}.calls")
except AttributeError:  # a program without the span: nothing to read
    COUNTERS = ()


def read(run):
    calls = run.counters.get(f"{SPAN}.calls")
    return run.counters[f"{SPAN}.seconds"] * 1e3 / calls if calls else None
