"""K2: % of the frozen bound of one gradient (portbench/roofline.py) over
the device ms of its record, adjoint and reduce kernels a step."""
from portbench import readers

K2 = r"\b(record_kernel|adjoint_kernel|reduce_blocks_kernel)\b"


def read(run):
    return readers.roofline(run, "k2", K2, per="unit")
