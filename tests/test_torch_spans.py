"""The port's spans and counters, and the benchmark's readers of them.

`utils/metrics.Span` totals a phase's host seconds and calls, a call that
raises included, and opens a `pt.<name>` record_function range only while
a profiler runs. `integrator/inverse.paired_step` counts its three phases
once a step. Each per-layer metric of `portbench/metrics/` that reads a
span or a counter of the program finds every path it lists, reads the
right value from a hand-made `tracing.Run`, and reads nothing from a
program without its span.

Marked `cuda` and skipped without a card: a frame of the analytical scene
counts each K1 wrapper span once and reads nothing from the card; a
training step adds record_plan's bytes to `record_bytes`; and the summed
`<function>.device_reads` counters equal the synchronizing calls that
torch's sync debug mode reports over a frame and a step. This file imports
no JAX; on a CUDA host run it by
`python -m pytest --noconftest tests/test_torch_spans.py -q`.
"""

import time
import warnings
from pathlib import Path

import pytest
import torch

from pathtracer_tpu_torch.integrator import inverse
from pathtracer_tpu_torch.integrator.tracer import VERBATIM, accumulate
from pathtracer_tpu_torch.models.analytical import make_scene
from pathtracer_tpu_torch.ops import megakernel as MK
from pathtracer_tpu_torch.ops import rng
from pathtracer_tpu_torch.utils.metrics import SPANS, Span
from portbench import spec, tracing

ROOT = Path(__file__).resolve().parents[1]
SPAN_METRICS = {
    "k1_keys_host_ms.frames": "k1_keys",
    "k1_pack_host_ms.frames": "k1_pack",
    "k1_enqueue_host_ms.frames": "k1_enqueue",
    "k2_wrapper_host_ms.train": "k2_wrapper",
    "step_forward_host_ms.train": "step_forward",
    "step_backward_host_ms.train": "step_backward",
    "step_adam_host_ms.train": "step_adam",
}
READS_METRICS = ("device_reads.frames", "device_reads.train")
STEP_SPANS = ("step_forward", "step_backward", "step_adam")
K1_SPANS = ("k1_keys", "k1_pack", "k1_enqueue")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def span():
    """A span of its own, taken out of SPANS again after the test."""
    s = Span("test_span_probe")
    yield s
    delattr(SPANS, s.name)


class RecordFunctionSpy:
    """Stands in for torch.profiler.record_function and counts entries."""

    real = torch.profiler.record_function
    entered = 0

    def __init__(self, name):
        self.inner = RecordFunctionSpy.real(name)

    def __enter__(self):
        RecordFunctionSpy.entered += 1
        return self.inner.__enter__()

    def __exit__(self, *exc):
        return self.inner.__exit__(*exc)


def test_span_totals_seconds_and_calls(span):
    assert SPANS.test_span_probe is span and span.label == "pt.test_span_probe"
    for _ in range(2):
        with span:
            time.sleep(0.002)
    assert span.calls == 2 and 0.004 <= span.seconds < 1.0
    with pytest.raises(KeyError):
        with span:
            raise KeyError("inside")
    assert span.calls == 3


@pytest.mark.parametrize("name", ["test_span_probe", "k1.pack", "not an identifier"])
def test_span_names_are_new_identifiers(span, name):
    with pytest.raises(ValueError):
        Span(name)


def test_a_range_opens_only_under_a_profiler(span, monkeypatch):
    monkeypatch.setattr(RecordFunctionSpy, "entered", 0)
    monkeypatch.setattr(torch.profiler, "record_function", RecordFunctionSpy)
    for _ in range(3):
        with span:
            pass
    assert RecordFunctionSpy.entered == 0
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with span:
                torch.ones(2).add_(1)
    assert RecordFunctionSpy.entered == 3 and span.calls == 6
    assert sum(e.name == "pt.test_span_probe" for e in prof.events()) == 3
    with span:
        pass
    assert RecordFunctionSpy.entered == 3


def trainer(device, width, height, kernel="eager"):
    """One analytical demo trainer as recover_demo builds it: a step call."""
    true, start = inverse.demo_scenes(4, device)
    render = inverse.make_renderer(kernel, width, height, 1, VERBATIM)
    with torch.no_grad():
        target = render(true, rng.prng_key(8))
    train, rebuild, _ = inverse.select_leaves(start, inverse.DEMO_SELECTS["analytical"])
    opt = inverse.make_adam(train, 3e-2)
    return lambda key: inverse.paired_step(train, rebuild, inverse.clamp_material_params, opt, render, target, key)


def calls(names):
    return [getattr(SPANS, n).calls for n in names]


def test_paired_step_counts_its_phases_once_a_step():
    step = trainer("cpu", 8, 6)
    before, seconds = calls(STEP_SPANS), [getattr(SPANS, n).seconds for n in STEP_SPANS]
    for i in range(2):
        step(rng.prng_key(i))
    assert calls(STEP_SPANS) == [c + 2 for c in before]
    assert all(getattr(SPANS, n).seconds > s for n, s in zip(STEP_SPANS, seconds))


def new_metrics():
    return list(SPAN_METRICS) + list(READS_METRICS) + ["k2_record_mb.train"]


@pytest.mark.parametrize("name", new_metrics())
def test_every_counter_path_resolves(name):
    module = spec.reader(ROOT, name)
    assert module.COUNTERS, name
    for path in module.COUNTERS:
        assert isinstance(tracing.read_counter(path), (int, float)), path


def run_of(counters, units=4):
    return tracing.Run(None, units, 1.0, tracing.Spans(), counters, None, [], {})


@pytest.mark.parametrize("name", list(SPAN_METRICS))
def test_span_readers(name):
    module = spec.reader(ROOT, name)
    path = f"pathtracer_tpu_torch.utils.metrics:SPANS.{SPAN_METRICS[name]}"
    assert module.COUNTERS == (f"{path}.seconds", f"{path}.calls")
    assert module.read(run_of({f"{path}.seconds": 0.006, f"{path}.calls": 3})) == pytest.approx(2.0)
    assert module.read(run_of({f"{path}.seconds": 0.0, f"{path}.calls": 0})) is None
    assert module.read(run_of({})) is None


@pytest.mark.parametrize("name", READS_METRICS)
def test_device_reads_readers(name):
    module = spec.reader(ROOT, name)
    assert "pathtracer_tpu_torch.ops.megakernel:scene_media.device_reads" in module.COUNTERS
    counters = {p: i + 1 for i, p in enumerate(module.COUNTERS)}
    want = sum(counters.values()) / 4
    assert module.read(run_of(counters)) == pytest.approx(want)
    assert module.read(run_of(counters, units=0)) is None


def test_record_bytes_reader():
    module = spec.reader(ROOT, "k2_record_mb.train")
    assert module.COUNTERS == ("pathtracer_tpu_torch.ops.megakernel:render_frame_megakernel.record_bytes",)
    assert module.read(run_of({module.COUNTERS[0]: 2_400_000_000})) == pytest.approx(600.0)
    assert module.read(run_of({})) is None


@pytest.mark.parametrize("name", list(SPAN_METRICS))
def test_a_program_without_the_span_reads_nothing(name, monkeypatch):
    monkeypatch.delattr(SPANS, SPAN_METRICS[name])
    module = spec.reader(ROOT, name)
    assert module.COUNTERS == () and module.read(run_of({})) is None


@pytest.mark.parametrize("name", new_metrics()[len(SPAN_METRICS):])
def test_a_program_without_the_counters_reads_nothing(name, monkeypatch):
    monkeypatch.delattr(MK.scene_media, "device_reads")
    monkeypatch.delattr(MK.render_frame_megakernel, "record_bytes")
    module = spec.reader(ROOT, name)
    assert module.COUNTERS == () and module.read(run_of({})) is None


# On the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the megakernels have no CPU mode")
    return torch.device("cuda", 0)


def device_reads():
    """Every `<function>.device_reads` counter the benchmark sums, summed."""
    return sum(tracing.read_counter(p) for p in spec.reader(ROOT, "device_reads.train").COUNTERS)


@pytest.mark.cuda
def test_a_frame_counts_each_k1_span_once(cuda_device):
    scene, key = make_scene(device=cuda_device), rng.prng_key(5)
    pixels, n = torch.zeros((240, 320, 4), device=cuda_device), torch.zeros((), device=cuda_device)
    pixels, n = accumulate(pixels, MK.render_frame_megakernel(scene, key, 320, 240), n)  # builds, checks the scene
    torch.cuda.synchronize()
    before, reads = calls(K1_SPANS), device_reads()
    accumulate(pixels, MK.render_frame_megakernel(scene, rng.split(key)[0], 320, 240), n)
    torch.cuda.synchronize()
    assert calls(K1_SPANS) == [c + 1 for c in before]
    assert device_reads() == reads


@pytest.mark.cuda
def test_a_step_adds_record_plans_bytes(cuda_device):
    step = trainer(cuda_device, 320, 240, "megakernel")
    step(rng.prng_key(1))
    before = MK.render_frame_megakernel.record_bytes
    step(rng.prng_key(2))
    k = MK.prepare_launch(make_scene(device=cuda_device), rng.prng_key(2), 320, 240, 1, VERBATIM)
    assert MK.render_frame_megakernel.record_bytes - before == MK.record_plan(k)[0] > 0


@pytest.mark.cuda
def test_device_reads_are_the_synchronizing_calls(cuda_device):
    scene = make_scene(device=cuda_device)
    step = trainer(cuda_device, 320, 240, "megakernel")
    MK.render_frame_megakernel(scene, rng.prng_key(3), 320, 240)
    step(rng.prng_key(3))
    torch.cuda.synchronize()
    before = device_reads()
    torch.cuda.set_sync_debug_mode("warn")  # its first call in a process may warn itself
    try:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            MK.render_frame_megakernel(scene, rng.prng_key(4), 320, 240)
            step(rng.prng_key(4))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    syncs = [w for w in seen if "synchronizing" in str(w.message)]
    assert device_reads() - before == len(syncs) > 0
