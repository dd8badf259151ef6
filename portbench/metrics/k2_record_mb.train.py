"""K2 record kernel: MB of record buffer a step, the program's counter
`render_frame_megakernel.record_bytes` (ops/megakernel.launch_backward adds
record_plan's bytes each call; the record kernel writes them, the adjoint
kernel reads them back)."""
from portbench import readers
from portbench.tracing import read_counter

PATH = "pathtracer_tpu_torch.ops.megakernel:render_frame_megakernel.record_bytes"
try:
    read_counter(PATH)
    COUNTERS = (PATH,)
except AttributeError:  # a program without the counter: nothing to read
    COUNTERS = ()


def read(run):
    per_step = readers.counter_per_unit(run, PATH)
    return per_step / 1e6 if per_step is not None else None
