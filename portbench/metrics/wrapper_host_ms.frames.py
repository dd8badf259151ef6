"""Kernel wrappers: host ms of a render_frame_megakernel call (pack, keys,
launch; it returns once K1 is enqueued), the benchmark's span around it."""
from portbench import readers


def read(run):
    return readers.span_ms(run, "wrapper")
