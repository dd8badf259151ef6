"""Device: % of the traced window with no kernel, copy or set on the card
(rank 0's in a cell on several cards, where an NCCL kernel waiting for its
peers counts as busy)."""
from portbench import readers


def read(run):
    return readers.idle_share(run)
