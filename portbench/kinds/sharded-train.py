"""Traffic kind `sharded-train`: the inverse-rendering step over a mesh of
pixel ranges, one rank a card (`parallel/mesh.paired_step_sharded`, as
`python -m torch.distributed.run --nproc-per-node 4 -m
pathtracer_tpu_torch.app.invert --mesh 4` runs it); its first steps feed
the training comparison.

`Train`'s job on every rank of the process group (`ranks.py`): the
config's trained leaves, projection and Adam, the target the mean of
`target_frames` sharded renders (`render_frame_sharded_megakernel`,
assembled on every rank), each step's keys `traffic.step_key`. The mesh
puts every rank on the tiles axis (`make_mesh(world, 1)`), so each holds a
contiguous 128-aligned range of the frame's pixels, runs K1 and K2 over it,
and sums its gradient and loss with the others'. Set-up drives the checked
steps as `Train` does; the first gradient and the change are the reduced
ones, the same on every rank, and rank 0 keeps them. The ranks step in lock
step; the window ends only at a loss read (every `loss_every` steps), where
rank 0's clock decides and a one-element all-reduce carries the decision,
and the last step is synchronised on every rank before rank 0 closes it.

Its faults are the training faults where the sharded trainer produces the
same things (the state: Adam; half the batch: each rank's loss over the
first half of its pixels, averaged over them; the answer: its loss x1.5;
the gradient: K2's x1.5), and two of the exchange:
- `unreduced_gradient`: `reduce_grads` left out, so each rank's Adam steps
  on its own range's gradient;
- `dropped_range`: the last rank's share of the loss and of the gradient
  zeroed before the all-reduces.
`dead_rank` is no fault of the answer: the last rank exits abruptly in its
sixth step, inside the window, and the run has to end.
"""
import contextlib
import os
import time
from unittest import mock

import torch
import torch.distributed as dist

from portbench import faults
from portbench import traffic as gen
from portbench.drivers import Train, _sync


class ShardedTrain(Train):
    """`Train` over the ranks' pixel ranges."""

    def __init__(self, cell, seed: int, device: torch.device, spans, size=None):
        super().__init__(cell, seed, device, spans, size)
        from pathtracer_tpu_torch.integrator.tracer import VERBATIM
        from pathtracer_tpu_torch.parallel import mesh

        self.sharding, self.quirks = mesh, VERBATIM
        self.mesh = mesh.make_mesh(mesh.world()[1], 1)
        self.render = lambda s, k: mesh.render_frame_sharded_megakernel(s, k, self.mesh, self.width, self.height,
                                                                         self.spp, VERBATIM)

    def step(self):
        return self.sharding.paired_step_sharded(self.train, self.rebuild, self.projection, self.opt, self.mesh,
                                                 "megakernel", self.width, self.height, self.spp, self.quirks,
                                                 self.target, gen.step_key(self.seed, self.steps))

    def window(self, seconds: float, profiler=None) -> None:
        span = self.spans.span
        stop = torch.zeros(1, dtype=torch.float32, device=self.device)
        done = 0
        t0 = time.perf_counter()
        while True:
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
                    stop.fill_(float(self.mesh.rank == 0 and time.perf_counter() - t0 >= seconds))
                    dist.all_reduce(stop)
                    if float(stop):
                        break
            if profiler is not None and profiler.tick(done):
                self.spans.reset()
        with span("sync"):
            _sync(self.device)
            dist.all_reduce(stop)  # every rank's last step is done
            _sync(self.device)
        self.window_s = time.perf_counter() - t0
        self.window_steps = done

    def free(self) -> None:
        super().free()
        self.mesh = None


DRIVER = ShardedTrain
COMPARES = "train"
FAULTS = faults.TRAIN_FAULTS + ("unreduced_gradient", "dropped_range")
DEAD_RANK, DIES_AT = "dead_rank", 5  # the last rank's step call (0-based) at which it exits


def _last_rank() -> bool:
    return dist.get_rank() == dist.get_world_size() - 1


@contextlib.contextmanager
def _rows(kept: float, scale: float):
    """Each rank's loss over the first `kept` share of its pixels, averaged
    over them, times `scale`: its rows cut to that share, and their
    gradient and its loss (the 0-d all-reduce) times scale / kept."""
    from pathtracer_tpu_torch.parallel import mesh

    rank_rows, all_reduce, f = mesh.rank_rows, mesh.all_reduce, scale / kept

    def cut(*args):
        rows, (begin, count) = rank_rows(*args)
        n = int(count * kept)
        rows = rows[:n]
        if rows.requires_grad:
            rows.register_hook(lambda g: g * f)
        return rows, (begin, n)

    def scaled(t, group):
        return all_reduce(t * f if t.dim() == 0 else t, group)
    with mock.patch.object(mesh, "rank_rows", cut), mock.patch.object(mesh, "all_reduce", scaled):
        yield


def plant(fault: str):
    """The patch of `fault` in `parallel/mesh.paired_step_sharded` (its
    stale state is the trainer's)."""
    from pathtracer_tpu_torch.parallel import mesh

    if fault == "stale_state":
        return faults.train_fault(fault)
    if fault == "half_batch":
        return _rows(0.5, 1.0)
    if fault == "altered_answer":
        return _rows(1.0, 1.5)
    if fault == "altered_gradient":
        render = mesh.render_frame_megakernel

        def scaled(*args):
            img = render(*args)
            if img.requires_grad:
                img.register_hook(lambda g: g * 1.5)
            return img
        return mock.patch.object(mesh, "render_frame_megakernel", scaled)
    if fault == "unreduced_gradient":
        return mock.patch.object(mesh, "reduce_grads", lambda train, m: None)
    if fault == "dropped_range":
        all_reduce = mesh.all_reduce

        def dropped(t, group):  # the loss (0-d) and the flat gradient (1-d), not a frame
            if t.dim() <= 1 and group is not None and _last_rank():
                t.zero_()
            return all_reduce(t, group)
        return mock.patch.object(mesh, "all_reduce", dropped)
    if fault != DEAD_RANK:
        raise ValueError(f"unknown fault {fault!r} for sharded-train")
    step, calls = mesh.paired_step_sharded, []

    def dying(*args):
        calls.append(None)
        if len(calls) > DIES_AT and _last_rank():
            os._exit(9)
        return step(*args)
    return mock.patch.object(mesh, "paired_step_sharded", dying)
