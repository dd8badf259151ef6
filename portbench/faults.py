"""Faults planted in the program underneath a run, to show that the
correctness check fails them (`tests/test_portbench_faults.py` on the CPU,
`calibrate.py` on the card, where they give a training cell's numbers
their upper readings). Each is a context manager that patches the port
where the answer is produced; a cell on one card has no exchange between
cards to leave out.

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


def faults_of(kind: str) -> tuple:
    """The faults a cell of traffic `kind` can have."""
    return TRAIN_FAULTS if kind == "train" else FAULTS


@contextlib.contextmanager
def planted(kind: str, fault: str):
    """Plant `fault` in the program for a cell of traffic `kind`."""
    from pathtracer_tpu_torch.integrator import inverse, tracer
    from pathtracer_tpu_torch.ops import megakernel

    if fault not in faults_of(kind):
        raise ValueError(f"unknown fault {fault!r} for {kind!r}")
    render = megakernel.render_frame_megakernel
    if kind == "frames":
        if fault == "stale_state":
            patch = mock.patch.object(tracer, "accumulate", lambda pixels, frame, frames: (pixels, frames + 1))
        elif fault == "half_batch":
            def half(scene, key, width, height, spp=1, quirks=tracer.VERBATIM, pixels=None):
                return render(scene, key, width, height, spp, quirks, (0, width * height // 2))
            patch = mock.patch.object(megakernel, "render_frame_megakernel", half)
        else:
            def other_key(scene, key, width, height, spp=1, quirks=tracer.VERBATIM, pixels=None):
                return render(scene, rng.fold_in(key, 1), width, height, spp, quirks, pixels)
            patch = mock.patch.object(megakernel, "render_frame_megakernel", other_key)
    else:
        loss = inverse.paired_image_loss
        if fault == "stale_state":
            make_adam = inverse.make_adam

            def frozen_adam(train, lr):
                opt = make_adam(train, lr)
                opt.step = lambda closure=None: None
                return opt
            patch = mock.patch.object(inverse, "make_adam", frozen_adam)
        elif fault == "altered_gradient":
            make_renderer = inverse.make_renderer

            def scaled_backward(*args):
                render = make_renderer(*args)

                def scaled(scene, key):
                    img = render(scene, key)
                    if img.requires_grad:
                        img.register_hook(lambda g: g * 1.5)
                    return img
                return scaled
            patch = mock.patch.object(inverse, "make_renderer", scaled_backward)
        elif fault == "half_batch":
            def top_half(img_a, img_b, target):
                h = img_a.shape[0] // 2
                return loss(img_a[:h], img_b[:h], target[:h])
            patch = mock.patch.object(inverse, "paired_image_loss", top_half)
        else:
            patch = mock.patch.object(inverse, "paired_image_loss", lambda a, b, t: loss(a, b, t) * 1.5)
    with patch:
        yield
