"""K1: % of the frozen bound of one frame (portbench/roofline.py, the
reference's segments and march steps) over the device ms a launch."""
from portbench import readers

K1 = r"\brender_forward_kernel\b"


def read(run):
    return readers.roofline(run, "k1", K1, per="launch")
