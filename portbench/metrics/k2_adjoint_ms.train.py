"""K2 adjoint kernel: device ms a training step (csrc/megakernel_bwd.cuh
adjoint_kernel, every chunk)."""
from portbench import readers


def read(run):
    return readers.kernel_ms(run, r"\badjoint_kernel\b", per="unit")
