"""Trainer: host ms of an inverse.paired_step call (two K1 renders, K2, the
loss, Adam, as enqueued), the benchmark's span around it; in a cell on
several cards rank 0's parallel/mesh.paired_step_sharded call (its range's
renders and K2, the gradient's and the loss's all-reduces, Adam; its waits
for the card and its peers)."""
from portbench import readers


def read(run):
    return readers.span_ms(run, "step")
