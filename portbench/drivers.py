"""The system under test, driven as its users drive it: the drivers of the
one-card traffic kinds, which `kinds/frames.py` and `kinds/train.py` name
(a kind may define its driver in its own file). Each builds the program's
own objects from the cell's files, warms up every shape the window uses,
runs the measured window, and hands what the window produced to the
correctness check.

Everything here calls the port (`pathtracer_tpu_torch`) and nothing else
of the repository; the program is imported when a driver is built, never
when this module is.

- `Frames` is the render CLI's progressive loop (`app/render.render`,
  app/render.py:197-209): per frame a key split from the last, one
  `render_frame_megakernel` (K1 with the scene's backend), `accumulate`
  into the running mean, and a synchronize. A frame's latency, for the
  per-layer tail, runs from the start of its key split to the end of its
  accumulation on the card (CUDA events on the stream, which idles
  between frames, so the first event is stamped when the host reaches
  it); only a traced window, which alone reads it, records them.
- `Train` is `integrator/inverse.paired_step` as `recover_demo` drives
  it: the config's trained leaves and projection, Adam, a target of the
  true scene; steps dispatched back to back, the loss read to the host
  every `loss_every` steps, an episode of `episode` steps after which the
  start values and Adam's state are restored in place, so the work stays
  the same through the window. Set-up drives the same object through the
  first `steps` steps (`checks/<cell>.json`) of the window's feed and
  keeps what the comparison reads (the losses, the first gradient as Adam holds it, the
  leaves' change), then the window goes on from there. Once the window
  has closed, `masked_grad` takes the first step's renders and loss
  again, some pixels left out, for the check's `grad_gap_masked`.
"""

from __future__ import annotations

import time

import torch

from . import traffic as gen
from .tracing import Spans, log

WARMUP_FRAMES = 3


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Frames:
    """The progressive render of one scene, frame by frame."""

    def __init__(self, cell, seed: int, device: torch.device, spans: Spans, size=None):
        t = time.perf_counter()
        from pathtracer_tpu_torch.integrator import tracer
        from pathtracer_tpu_torch.ops import megakernel
        from pathtracer_tpu_torch.utils.sceneio import scene_from_dict

        log("set-up: the program imported", t)
        mix = cell.traffic
        self.width, self.height = size or (int(mix["width"]), int(mix["height"]))
        self.spp, self.seed, self.device, self.spans = int(mix["spp"]), seed, device, spans
        self.mk, self.tracer = megakernel, tracer
        self.scene = scene_from_dict(cell.config["scene"], device=device, dtype=torch.float32)
        self.sample = gen.Reservoir(int(cell.checks["sample"]), seed)
        # the compared frames' (frame, buffer before, buffer after), copied
        # on the card into slots made in set-up: keeping the tensors
        # themselves would make the allocator take new memory in the window
        self.slots = []
        self.last = None
        self.latency_ms: list = []  # each frame's, ms
        self.frames = 0
        self.window_s = None

    def new_buffer(self):
        return (torch.zeros((self.height, self.width, 4), dtype=torch.float32, device=self.device),
                torch.zeros((), dtype=torch.float32, device=self.device))

    def render(self, key):
        return self.mk.render_frame_megakernel(self.scene, key, self.width, self.height, self.spp,
                                               self.tracer.VERBATIM)

    def setup(self) -> None:
        """Builds K1's library for the scene (the first run of a checkout
        compiles it) and runs every operation of a frame."""
        t = time.perf_counter()
        pixels, n = self.new_buffer()
        self.slots = [tuple(torch.empty_like(pixels) for _ in range(3)) for _ in range(self.sample.size + 1)]
        key = gen.warmup_key(self.seed)
        for i in range(WARMUP_FRAMES):
            pixels, n = self.tracer.accumulate(pixels, self.render(key), n)
            _sync(self.device)
            t = log(f"set-up: warm-up frame {i}", t)

    def window(self, seconds: float, profiler=None) -> None:
        cuda = self.device.type == "cuda"
        timed = profiler is not None
        if cuda and timed:
            ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        keys = gen.frame_keys(self.seed)
        pixels, n = self.new_buffer()
        span = self.spans.span
        i = 0
        t0 = time.perf_counter()
        while True:
            tf = time.perf_counter()
            if cuda and timed:
                ev0.record()
            with span("key_split"):
                key = next(keys)
            with span("wrapper"):
                frame = self.render(key)
            with span("accumulate"):
                new, n = self.tracer.accumulate(pixels, frame, n)
            if cuda and timed:
                ev1.record()
            with span("sync"):
                _sync(self.device)
            if timed:
                self.latency_ms.append(ev0.elapsed_time(ev1) if cuda else (time.perf_counter() - tf) * 1e3)
            slot = self.sample.offer(i, key)
            if slot is not None:
                for dst, src in zip(self.slots[slot], (frame, pixels, new)):
                    dst.copy_(src)
            self.last = (i, key, frame, pixels, new)
            pixels = new
            i += 1
            if profiler is not None and profiler.tick(i):
                self.latency_ms.clear()
                self.spans.reset()
            if time.perf_counter() - t0 >= seconds:
                break
        self.window_s = time.perf_counter() - t0
        self.frames = i

    def units(self) -> int:
        return self.frames

    def end_to_end(self) -> dict:
        return {"frame_ms": self.window_s * 1e3 / self.frames}

    def outputs(self) -> dict:
        """The compared frames: (index, key, frame, buffer before, buffer
        after) of the first, a sample drawn from the seed, and the last."""
        kept = [(index, key, *self.slots[slot]) for slot, (index, key) in sorted(self.sample.slots.items())]
        return {"frames": kept + ([self.last] if self.last[0] not in {k[0] for k in kept} else [])}

    def free(self) -> None:
        self.scene = None

    def work_key(self):
        """The key of the window's first frame, whose work the rooflines count."""
        return next(gen.frame_keys(self.seed))


class Train:
    """Inverse-rendering steps of one scene's trainer."""

    def __init__(self, cell, seed: int, device: torch.device, spans: Spans, size=None):
        t = time.perf_counter()
        from pathtracer_tpu_torch.integrator import inverse, tracer
        from pathtracer_tpu_torch.utils.sceneio import scene_from_dict

        t = log("set-up: the program imported", t)
        mix, c = cell.traffic, cell.config["train"]
        self.width, self.height = size or (int(mix["width"]), int(mix["height"]))
        self.spp, self.seed, self.device, self.spans = int(mix["spp"]), seed, device, spans
        self.episode, self.loss_every = int(mix["episode"]), int(mix["loss_every"])
        self.checked, self.target_frames, self.lr = (int(cell.checks["steps"]), int(mix["target_frames"]),
                                                     float(mix["lr"]))
        self.inverse = inverse
        true = scene_from_dict(cell.config["scene"], device=device, dtype=torch.float32)
        start = scene_from_dict(c["start"], device=device, dtype=torch.float32)
        self.train, self.rebuild, self.names = inverse.select_leaves(start, c["select"])
        self.start_values = [v.detach().clone() for v in self.train]
        self.projection = getattr(inverse, c["projection"])
        self.opt = inverse.make_adam(self.train, self.lr)
        self.render = inverse.make_renderer("megakernel", self.width, self.height, self.spp, tracer.VERBATIM)
        self.true = true
        log("set-up: the scenes, the trained leaves and Adam", t)
        self.target = None
        self.steps = 0  # steps taken, set-up's included: the next step's index
        self.window_steps = 0
        self.window_s = None
        self.checked_out = None
        self.latency_ms: list = []  # frames only

    def step(self):
        return self.inverse.paired_step(self.train, self.rebuild, self.projection, self.opt, self.render,
                                        self.target, gen.step_key(self.seed, self.steps))

    def restore(self) -> None:
        """The start values and a fresh Adam state, in place."""
        with torch.no_grad():
            for t, s in zip(self.train, self.start_values):
                t.copy_(s)
            for st in self.opt.state.values():
                for name in ("exp_avg", "exp_avg_sq", "step"):
                    st[name].zero_()

    def setup(self) -> None:
        """The target (the mean of `target_frames` renders of the true
        scene), then the checked first steps, which build K1's and
        K2's libraries and run every operation of a step."""
        t = time.perf_counter()
        with torch.no_grad():
            keys = gen.target_keys(self.seed, self.target_frames)
            self.target = sum(self.render(self.true, k) for k in keys) / float(self.target_frames)
        self.true = None
        _sync(self.device)
        t = log("set-up: target", t)
        losses, first_grad = [], None
        beta1 = self.opt.param_groups[0]["betas"][0]
        for i in range(self.checked):
            losses.append(float(self.step()))
            self.steps += 1
            t = log(f"set-up: step {i}", t)
            if first_grad is None:
                first_grad = [(self.opt.state[t]["exp_avg"] / (1.0 - beta1)).detach().clone() if t in self.opt.state
                              else torch.zeros_like(t) for t in self.train]
        change = [(t.detach() - s).clone() for t, s in zip(self.train, self.start_values)]
        self.checked_out = {"names": list(self.names), "losses": losses,
                            "first_grad": [g.cpu() for g in first_grad], "change": [c.cpu() for c in change]}
        _sync(self.device)

    def window(self, seconds: float, profiler=None) -> None:
        span = self.spans.span
        done = 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            if self.steps % self.episode == 0:
                with span("restore"):
                    self.restore()
            with span("step"):
                loss = self.step()
            self.steps += 1
            done += 1
            if self.steps % self.loss_every == 0:
                with span("loss_read"):
                    float(loss)
            if profiler is not None and profiler.tick(done):
                self.spans.reset()
        with span("sync"):
            _sync(self.device)
        self.window_s = time.perf_counter() - t0
        self.window_steps = done

    def units(self) -> int:
        return self.window_steps

    def end_to_end(self) -> dict:
        return {"step_ms": self.window_s * 1e3 / self.window_steps}

    def outputs(self) -> dict:
        return {"train": self.checked_out}

    def masked_grad(self, first) -> tuple:
        """(gradient, keep, {what: pixels}): the gradient of the trained
        leaves that the first checked step took, from the same start
        values, keys and target, through the window's renderer and paired
        loss, with the pixels that `first.keep_of` (`check.FirstStep`)
        leaves out of this step's renders and target left out of the
        loss; gradient and keep None where it leaves out too many."""
        ka, kb = self.inverse.rng.split(gen.step_key(self.seed, 0))
        train = [s.clone().requires_grad_(True) for s in self.start_values]
        scene = self.projection(self.rebuild(train))
        img_a = self.render(scene, ka)
        with torch.no_grad():
            img_b = self.render(scene, kb)
        keep, counts = first.keep_of(img_a.detach(), img_b, self.target)
        if keep is None:
            return None, None, counts
        k = keep.to(device=img_a.device, dtype=img_a.dtype)
        loss = self.inverse.paired_image_loss(img_a * k, img_b * k, self.target * k)
        grads = torch.autograd.grad(loss, train, allow_unused=True)
        return [(torch.zeros_like(t) if g is None else g).detach().cpu() for g, t in zip(grads, train)], keep, counts

    def free(self) -> None:
        self.train = self.opt = self.target = self.rebuild = self.start_values = None

    def work_key(self):
        """The key of the first step's differentiated render (paired_step's
        first split), whose work the rooflines count."""
        from .reference import rng

        return rng.split(gen.step_key(self.seed, 0))[0]

