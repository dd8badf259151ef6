"""Kernel wrappers: the share of K1's wrapper calls that used a scene's
packed vector again (ops/megakernel.packed_scene) instead of packing the
scene, in %: `prepare_launch.pack_reuses` over it plus
`prepare_launch.packs`, over the window."""
from portbench.tracing import read_counter

PLACES = ("pathtracer_tpu_torch.ops.megakernel:prepare_launch.pack_reuses",
          "pathtracer_tpu_torch.ops.megakernel:prepare_launch.packs")
try:
    for place in PLACES:
        read_counter(place)
    COUNTERS = PLACES
except AttributeError:  # a program without the counters: nothing to read
    COUNTERS = ()


def read(run):
    if not COUNTERS:
        return None
    reuses, packs = (run.counters.get(p, 0) for p in COUNTERS)
    return reuses * 100.0 / (reuses + packs) if reuses + packs else None
