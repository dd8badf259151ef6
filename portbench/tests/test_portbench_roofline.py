"""The frozen roofline arithmetic: the bounds the repository's builders
printed for the 1080p frames and gradients come back from their counts,
bit for bit what they were before each family's counts became a file of
its own (`bounds/<family>.py`); a family without such a file has no
bound, and a traced run of its cell leaves the rooflines out; and the
reference's counts of a small frame are what its own trace holds (every
primary ray is a segment; a path enters at most `depth` bounces; the SDF
scene's marches take at least a step a segment)."""

import time

import pytest

from portbench import check, harness, roofline, spec
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


# bound_ms's floats before the counts moved into bounds/<family>.py, on the
# builders' counts and on other counts at 640x480 with 83 scalars
BEFORE = {("k1", "analytical"): (0.11121307195785778, 0.03025185181738367),
          ("k1", "sdf"): (0.23856795948200177, 0.14269616470588234),
          ("k2", "analytical"): (0.2892775030728709, 0.07905735277655838),
          ("k2", "sdf"): (0.45175155948200174, 0.20313466858647936)}


@pytest.mark.parametrize("kernel, family", sorted(BEFORE))
def test_bounds_are_bit_for_bit_the_same(kernel, family):
    counts = ANALYTICAL if family == "analytical" else SDF
    other = {"segments": 1_234_567, "march_steps": 98_765_432}
    assert (bound_ms(kernel, family, counts, PIXELS, 112),
            bound_ms(kernel, family, other, 640 * 480, 83)) == BEFORE[(kernel, family)]


def test_an_unknown_family_has_no_bound():
    assert roofline.counts_of("mesh") is None and roofline.counts_of("sdf") is not None
    assert bound_ms("k1", "mesh", ANALYTICAL, PIXELS, 112) is None
    assert bound_ms("k2", "mesh", ANALYTICAL, PIXELS, 112) is None


@pytest.mark.parametrize("cell, roofline_metric", [("analytical.frames", "k1_roofline.frames"),
                                                   ("analytical.train", "k2_roofline.train")])
def test_a_family_without_counts_leaves_the_rooflines_out(monkeypatch, cell, roofline_metric):
    """A traced run of a cell whose family has no frozen counts: no bounds,
    no roofline in the line, the other metrics read."""
    c = spec.resolve(cell)
    key = next(gen.frame_keys(3))
    assert harness.reference_bounds(c, key, "cpu", 16, 8, 1)["k1"] > 0
    monkeypatch.setattr(roofline, "counts_of", lambda family, root=spec.ROOT: None)
    assert harness.reference_bounds(c, key, "cpu", 16, 8, 1) == {}
    result, _ = harness.run(cell, 9, 0.3, True, time.perf_counter(), device="cpu", size=(16, 8))
    assert result["correct"] and roofline_metric not in result["metrics"]
    assert any(name.startswith("idle_share") or name.endswith("host_ms.train") or name.startswith("k1_launches")
               for name in result["metrics"])


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
