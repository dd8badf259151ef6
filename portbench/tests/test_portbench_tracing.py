"""The trace's reduction: the device's busy time as the union of its
operations, the idle gaps put on what the host was doing, the kernels by
name, the Chrome trace read back, the readers' None where there is nothing
to read, and the seeded sample of compared frames."""

import json

import pytest

from portbench import readers, traffic
from portbench.tracing import Kernel, Run, Spans, Trace, host_labels, parse_chrome_trace

HOST = [("portbench.wrapper", 0, 100, 1), ("aten::add", 10, 20, 1), ("cudaLaunchKernel", 12, 15, 1),
        ("portbench.sync", 100, 200, 1), ("cudaStreamSynchronize", 101, 199, 1), ("autograd", 30, 60, 2)]


def test_host_labels_innermost_under_outermost_span():
    assert host_labels(HOST, [5, 13, 40, 150, 250]) == [
        "portbench.wrapper", "portbench.wrapper > cudaLaunchKernel", "portbench.wrapper > autograd",
        "portbench.sync > cudaStreamSynchronize", "host: outside every range"]


def test_busy_is_the_union_and_gaps_are_labelled():
    t = Trace([Kernel("void pt::render_forward_kernel<A>(x)", 16, 50), Kernel("b", 40, 30), Kernel("c", 120, 10)],
              1e-3, 2, HOST)
    assert t.busy_s == pytest.approx(64e-6)
    assert t.kernel_us(r"\brender_forward_kernel\b") == (50, 1)
    assert t.device_ops()[0] == ["void pt::render_forward_kernel<A>(x)", 50e-6]
    assert t.idle_gaps() == [["portbench.wrapper", pytest.approx(50e-6)]]


def test_chrome_trace_read_back(tmp_path):
    events = [{"ph": "X", "cat": "kernel", "name": "k", "ts": 5, "dur": 2},
              {"ph": "X", "cat": "cpu_op", "name": "aten::mul", "ts": 1, "dur": 3, "tid": 7},
              {"ph": "X", "cat": "user_annotation", "name": "portbench.step", "ts": 0, "dur": 9, "tid": 7},
              {"ph": "i", "cat": "kernel", "name": "marker", "ts": 3}]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    ops, host = parse_chrome_trace(str(path))
    assert ops == [Kernel("k", 5.0, 2.0)] and len(host) == 2 and host[0][3] == 7


def run_of(trace=None, spans=None, latency=(), bounds=None):
    return Run(None, 10, 1.0, spans or Spans(), {"c": 10}, trace, list(latency), bounds or {})


def test_readers_read_nothing_without_a_trace():
    r = run_of()
    assert readers.idle_share(r) is None and readers.kernel_ms(r, "k") is None
    assert readers.roofline(r, "k1", "k") is None and readers.span_ms(r, "wrapper") is None
    assert readers.latency_p95(r) is None and readers.counter_per_unit(r, "missing") is None
    assert readers.counter_per_unit(r, "c") == 1.0


def test_readers_on_a_trace():
    spans = Spans()
    with spans.span("wrapper"):
        pass
    t = Trace([Kernel("k1x", 0, 100), Kernel("k1x", 200, 100)], 1e-3, 2, [])
    r = run_of(t, spans, latency=range(1, 101), bounds={"k1": 0.05})
    assert readers.idle_share(r) == pytest.approx(80.0)
    assert readers.kernel_ms(r, "k1x", per="launch") == pytest.approx(0.1)
    assert readers.roofline(r, "k1", "k1x", per="launch") == pytest.approx(50.0)
    assert readers.span_ms(r, "wrapper") >= 0 and readers.latency_p95(r) == 95


def test_reservoir_is_seeded_keeps_the_first_and_is_uniform():
    def sample(seed, n=1000):
        res = traffic.Reservoir(3, seed)
        slots = [res.offer(i, i) for i in range(n)]
        assert slots[0] == 0 and all(s is None or 0 <= s <= 3 for s in slots)
        return sorted(i for i, _ in res.slots.values())

    a = sample(2**33 + 1)
    assert a == sample(2**33 + 1) and a != sample(5)
    assert a[0] == 0 and len(a) == 4 and len(sample(7, n=3)) == 3
    late = sum(x >= 500 for seed in range(200) for x in sample(seed)[1:])
    assert 240 < late < 360  # half of the 600 sampled frames fall in the second half


def test_keys_are_the_seeds():
    k = traffic.frame_keys(2**40 + 3)
    first, second = next(k), next(k)
    assert not (first == second).all()
    assert (traffic.step_key(9, 4) == traffic.step_key(9, 4)).all()
    assert not (traffic.step_key(9, 4) == traffic.step_key(9, 5)).all()
