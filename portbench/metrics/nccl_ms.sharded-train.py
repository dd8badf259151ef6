"""Sharding: device ms a step in NCCL's kernels on rank 0's card (the
all-reduces of the gradient and the loss, and the harness's one-element
stop decision every `loss_every` steps). An all-reduce kernel spins until
its peers arrive, so this is the transfer plus rank 0's wait for the
slowest range."""
from portbench import readers


def read(run):
    return readers.kernel_ms(run, r"\bnccl", per="unit")
