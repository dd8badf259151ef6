"""K1: device ms a launch of the forward megakernel (csrc/megakernel_fwd.cuh
render_forward_kernel over the scene's backend; K5 on the SDF scene)."""
from portbench import readers

K1 = r"\brender_forward_kernel\b"


def read(run):
    return readers.kernel_ms(run, K1, per="launch")
