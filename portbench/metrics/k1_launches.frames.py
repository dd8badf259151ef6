"""Kernel wrappers: K1 launches a frame, the program's own counter."""
from portbench import readers

COUNTERS = ("pathtracer_tpu_torch.ops.megakernel:render_frame_megakernel.launches",)


def read(run):
    return readers.counter_per_unit(run, COUNTERS[0])
