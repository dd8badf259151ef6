"""Device: % of the traced window with no kernel, copy or set on the card."""
from portbench import readers


def read(run):
    return readers.idle_share(run)
