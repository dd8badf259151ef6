"""Kernel wrappers: host ms a call of the program's span `k1_pack`
(ops/megakernel.prepare_launch: the backend's packer and .contiguous(),
the packing's small device operations as enqueued).
The span's totals cover the whole window, its labelled second (the CPU
profiler's, which slows the host) included."""
import importlib

from portbench.tracing import read_counter

importlib.import_module("pathtracer_tpu_torch.ops.megakernel")  # which makes the span
SPAN = "pathtracer_tpu_torch.utils.metrics:SPANS.k1_pack"
try:
    read_counter(SPAN)
    COUNTERS = (f"{SPAN}.seconds", f"{SPAN}.calls")
except AttributeError:  # a program without the span: nothing to read
    COUNTERS = ()


def read(run):
    calls = run.counters.get(f"{SPAN}.calls")
    return run.counters[f"{SPAN}.seconds"] * 1e3 / calls if calls else None
