"""Render loop: the 95th percentile of a frame's latency (key split, K1,
accumulate, to the card's end; CUDA events a frame). The host paces the
frame in both frames cells (the card idles 40-70% of their windows), so
the tail swings with the host from run to run, too far for a bound: it is
read here, and moves frame_ms."""
from portbench import readers


def read(run):
    return readers.latency_p95(run)
