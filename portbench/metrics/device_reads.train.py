"""Trainer: the program's reads of the card to the host a step, every
`<function>.device_reads` counter summed: scene_media's check of the scene
paired_step rebuilds, the constants of the projection's maximum and
minimum uploaded with a blocking copy."""
from portbench.tracing import read_counter

# every place of the program that makes the host wait for the card
PLACES = ("pathtracer_tpu_torch.ops.megakernel:scene_media.device_reads",
          "pathtracer_tpu_torch.ops.vecmath:maximum.device_reads",
          "pathtracer_tpu_torch.ops.vecmath:minimum.device_reads")
try:
    for place in PLACES:
        read_counter(place)
    COUNTERS = PLACES
except AttributeError:  # a program without the counters: nothing to read
    COUNTERS = ()


def read(run):
    return sum(run.counters[p] for p in COUNTERS) / run.units if COUNTERS and run.units else None
