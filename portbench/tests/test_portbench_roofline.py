"""The frozen roofline arithmetic: the bounds the repository's builders
printed for the 1080p frames and gradients come back from their counts,
and the reference's counts of a small frame are what its own trace holds
(every primary ray is a segment; a path enters at most `depth` bounces;
the SDF scene's marches take at least a step a segment)."""

import pytest

from portbench import check, spec
from portbench import traffic as gen
from portbench.reference import work
from portbench.roofline import bound_ms

PIXELS = 1920 * 1080
# chip_smoke.py's counts of the 1080p frame of PRNGKey(5) and the bounds it
# printed from them (PERF.md, PR 12)
ANALYTICAL = {"segments": 4_504_256}
SDF = {"segments": 4_354_665, "march_steps": 83_917_448 + 27_155_326}


@pytest.mark.parametrize("kernel, family, counts, want", [
    ("k1", "analytical", ANALYTICAL, 0.1112),
    ("k1", "sdf", SDF, 0.2386),
    ("k2", "analytical", ANALYTICAL, 0.2893),
    ("k2", "sdf", SDF, 0.4518),
])
def test_bounds_of_the_builders_counts(kernel, family, counts, want):
    assert bound_ms(kernel, family, counts, PIXELS, 112) == pytest.approx(want, abs=5e-5)


def test_an_unknown_family_has_no_bound():
    with pytest.raises(ValueError):
        bound_ms("k1", "mesh", ANALYTICAL, PIXELS, 112)


@pytest.mark.parametrize("cell", ["analytical.frames", "sdf.frames"])
def test_counts_of_a_small_frame(cell):
    config = spec.resolve(cell).config
    scene = check.reference_scene(config, "cpu")
    w, h, depth = 20, 12, scene.recursion_depth
    key = next(gen.frame_keys(17))
    counts = work.count_work(scene, config["scene"]["family"], key, w, h)
    alive = []
    assert work.count_segments(scene, key, w, h, per_bounce=lambda a: alive.append(int(a.sum()))) == counts["segments"]
    assert alive[0] == w * h and len(alive) == depth and sum(alive) == counts["segments"]
    assert all(a >= b for a, b in zip(alive, alive[1:]))
    if "march_steps" in counts:
        assert counts["march_steps"] >= counts["segments"]
