"""A cell on several cards runs as one process a card (`ranks.py`): here
`analytical.sharded-train` as 2 and 4 gloo ranks on the CPU at 64x32,
where the port renders through its plain version. A sound run is correct;
each fault the sharded trainer can have, planted in every rank, is not; a
rank that dies in the window ends the run with no process left; a
traffic kind's driver is found by its name from a file, the one-card
kinds' the same classes as before; without the cards the cell asks for,
`run.py` exits with 2, its ranks ended. About two minutes."""

import os
import re
import subprocess
import sys
import time
from pathlib import Path

import pytest

from portbench import drivers, faults, harness, ranks, spec
from portbench import traffic as gen

ROOT = Path(__file__).resolve().parents[2]
CELL, KIND, SIZE = "analytical.sharded-train", "sharded-train", (64, 32)
DEAD_RANK = spec.kind(ROOT, KIND).DEAD_RANK


def run(n_ranks, seconds=0.3, seed=2**31 + 11):
    result, lines = harness.run(CELL, seed, seconds, False, time.perf_counter(), device="cpu", size=SIZE,
                                ranks=n_ranks)
    assert lines and all(line.startswith("check ") for line in lines)
    return result


@pytest.mark.parametrize("n_ranks", [2, 4])
def test_sharded_run_is_correct(n_ranks):
    result = run(n_ranks)
    assert result["correct"] and result["failed"] == 0, result["checks"]
    assert result["device"]["count"] == n_ranks and set(result["metrics"]) == {"step_ms", "setup_s"}
    # the window ends at a loss read, every 10 steps counted from the 2 checked ones
    assert (result["attempted"] + 2) % 10 == 0


@pytest.mark.parametrize("fault", faults.faults_of(KIND))
def test_fault_is_not_correct(fault):
    with faults.planted(KIND, fault):
        result = run(4 if fault == "dropped_range" else 2)
    assert not result["correct"] and result["failed"] >= 1, result["checks"]


def gone(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] == "Z"
    except FileNotFoundError:
        return True


def test_a_dead_rank_ends_the_run():
    """The last of 3 ranks exits in its sixth step, inside a 60 s window:
    the run ends at once with another code than 0 (ranks.DIED where rank
    0's watchdog sees the exit first, 1 where its collective fails first),
    every rank gone."""
    code = (
        "import sys, time; sys.path.insert(0, %r)\n"
        "import torch; torch.set_num_threads(1)\n"
        "from portbench import faults, harness\n"
        "with faults.planted(%r, %r):\n"
        "    harness.run(%r, 5, 60.0, False, time.perf_counter(), device='cpu', size=%r, ranks=3)\n"
    ) % (str(ROOT), KIND, DEAD_RANK, CELL, SIZE)
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=ranks.TIMEOUT_S + 60, cwd=ROOT)
    elapsed = time.perf_counter() - t0
    assert out.returncode != 0 and out.stdout == "", out.stderr[-3000:]
    assert elapsed < 60, elapsed  # ended inside the window, not at its end
    pids = [int(p) for p in re.findall(r"portbench: rank \d+ is process (\d+)", out.stderr)]
    assert len(pids) == 2 and all(gone(p) for p in pids)


def test_kinds_are_found_by_name():
    assert spec.kinds(ROOT) == ["frames", "sharded-train", "train"]
    assert spec.kind(ROOT, "frames").DRIVER is drivers.Frames and spec.kind(ROOT, "frames").COMPARES == "frames"
    assert spec.kind(ROOT, "train").DRIVER is drivers.Train and spec.kind(ROOT, "train").COMPARES == "train"
    sharded = spec.kind(ROOT, KIND)
    assert issubclass(sharded.DRIVER, drivers.Train) and sharded.COMPARES == "train"
    for cell, driver in (("analytical.frames", drivers.Frames), ("sdf.frames", drivers.Frames),
                         ("analytical.train", drivers.Train), ("sdf.train", drivers.Train)):
        assert spec.resolve(cell, ROOT).kind.DRIVER is driver, cell
    gen.check_traffic(spec.resolve(CELL, ROOT).traffic, spec.kinds(ROOT))
    with pytest.raises(ValueError):
        gen.check_traffic({"kind": "no-such-kind", "width": 1, "height": 1, "spp": 1}, spec.kinds(ROOT))
    with pytest.raises(FileNotFoundError):
        spec.kind(ROOT, "no-such-kind")


def test_without_the_cards_run_exits_2():
    env = {k: v for k, v in os.environ.items() if k != "CUDA_VISIBLE_DEVICES"}
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", CELL, "--seed", "1", "--seconds", "1"],
                         capture_output=True, text=True, timeout=120, cwd=ROOT, env=dict(env, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode == 2 and out.stdout == "", out.stderr[-2000:]
    pids = [int(p) for p in re.findall(r"portbench: rank \d+ is process (\d+)", out.stderr)]
    assert len(pids) == 3 and all(gone(p) for p in pids)  # spawned before the look for cards, then ended
