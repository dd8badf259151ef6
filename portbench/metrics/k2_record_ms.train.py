"""K2 record kernel: device ms a training step (csrc/megakernel_bwd.cuh
record_kernel, every chunk)."""
from portbench import readers


def read(run):
    return readers.kernel_ms(run, r"\brecord_kernel\b", per="unit")
