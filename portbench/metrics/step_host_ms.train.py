"""Trainer: host ms of an inverse.paired_step call (two K1 renders, K2, the
loss, Adam, as enqueued), the benchmark's span around it."""
from portbench import readers


def read(run):
    return readers.span_ms(run, "step")
