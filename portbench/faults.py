"""Faults planted in the program underneath a run, to show that the
correctness check fails them (`tests/test_portbench_faults.py` on the CPU,
`calibrate.py` on the card, where they give a training cell's numbers
their upper readings). Each is a context manager that patches the port
where the answer is produced. A traffic kind declares the faults its
cells can have (`kinds/<kind>.py`: `FAULTS`, and `plant(fault)`, the
patch); this module holds the one-card kinds' patches, which the others
may reuse. In a cell on several cards (`ranks.py`) rank 0 hands the fault
planted in it (`active`) to every other rank, which plants it too.

- `stale_state`: a step that returns its state unchanged (frames: the
  accumulation keeps the old buffer; training: Adam's step moves nothing);
- `half_batch`: half of the batch left out (frames: K1 renders half the
  pixels; training: the loss is the mean over the top half of the rows);
- `altered_answer`: an answer altered where it is produced (frames: the
  frame is rendered from another key; training: the loss, and so the
  gradient, scaled by 1.5);
- `altered_gradient` (training): the gradient altered where it is
  produced, the render's backward (K2 on the card) returning 1.5 times
  its gradient; the loss stays right, and Adam's first steps move the
  same (its update is blind to the gradient's scale), so only a gradient
  number sees it.
"""

from __future__ import annotations

import contextlib
from unittest import mock

from .reference import rng

FAULTS = ("stale_state", "half_batch", "altered_answer")
TRAIN_FAULTS = FAULTS + ("altered_gradient",)
_planted: list = []  # the faults planted in this process, innermost last


def _kind(kind: str):
    from . import spec

    return spec.kind(spec.ROOT, kind)


def faults_of(kind: str) -> tuple:
    """The faults a cell of traffic `kind` can have."""
    return _kind(kind).FAULTS


def active() -> str | None:
    """The fault planted in this process now, or None."""
    return _planted[-1] if _planted else None


@contextlib.contextmanager
def planted(kind: str, fault: str):
    """Plant `fault` in the program for a cell of traffic `kind`."""
    patch = _kind(kind).plant(fault)
    _planted.append(fault)
    try:
        with patch:
            yield
    finally:
        _planted.pop()


def frames_fault(fault: str):
    """The patch of `fault` in the progressive render loop."""
    from pathtracer_tpu_torch.integrator import tracer
    from pathtracer_tpu_torch.ops import megakernel

    render = megakernel.render_frame_megakernel
    if fault == "stale_state":
        return mock.patch.object(tracer, "accumulate", lambda pixels, frame, frames: (pixels, frames + 1))
    if fault == "half_batch":
        def half(scene, key, width, height, spp=1, quirks=tracer.VERBATIM, pixels=None):
            return render(scene, key, width, height, spp, quirks, (0, width * height // 2))
        return mock.patch.object(megakernel, "render_frame_megakernel", half)
    if fault == "altered_answer":
        def other_key(scene, key, width, height, spp=1, quirks=tracer.VERBATIM, pixels=None):
            return render(scene, rng.fold_in(key, 1), width, height, spp, quirks, pixels)
        return mock.patch.object(megakernel, "render_frame_megakernel", other_key)
    raise ValueError(f"unknown fault {fault!r} for frames")


def train_fault(fault: str):
    """The patch of `fault` in `integrator/inverse.paired_step`."""
    from pathtracer_tpu_torch.integrator import inverse

    loss = inverse.paired_image_loss
    if fault == "stale_state":
        make_adam = inverse.make_adam

        def frozen_adam(train, lr):
            opt = make_adam(train, lr)
            opt.step = lambda closure=None: None
            return opt
        return mock.patch.object(inverse, "make_adam", frozen_adam)
    if fault == "altered_gradient":
        make_renderer = inverse.make_renderer

        def scaled_backward(*args):
            render = make_renderer(*args)

            def scaled(scene, key):
                img = render(scene, key)
                if img.requires_grad:
                    img.register_hook(lambda g: g * 1.5)
                return img
            return scaled
        return mock.patch.object(inverse, "make_renderer", scaled_backward)
    if fault == "half_batch":
        def top_half(img_a, img_b, target):
            h = img_a.shape[0] // 2
            return loss(img_a[:h], img_b[:h], target[:h])
        return mock.patch.object(inverse, "paired_image_loss", top_half)
    if fault == "altered_answer":
        return mock.patch.object(inverse, "paired_image_loss", lambda a, b, t: loss(a, b, t) * 1.5)
    raise ValueError(f"unknown fault {fault!r} for train")
