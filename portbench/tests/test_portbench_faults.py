"""A whole run with the timed path broken underneath comes out not
correct, once for each fault a one-card cell can have (`faults.py`: a step
that returns its state unchanged, half of the batch left out, an answer
altered where it is produced, and for training the gradient altered where
it is produced); the same run unbroken comes out correct.
On the CPU at a small size, past the harness's look for a card: the
program renders through its plain version there, so a sound run reads 0
on every number and the cells' own limits apply."""

import time

import pytest

from portbench import faults, harness

SIZES = {"analytical.frames": (24, 16), "sdf.frames": (16, 8), "analytical.train": (16, 12), "sdf.train": (12, 8)}


def run(cell, seed=2**31 + 9):
    result, lines = harness.run(cell, seed, 0.2, False, time.perf_counter(), device="cpu", size=SIZES[cell])
    assert lines and all(line.startswith("check ") for line in lines)
    return result


@pytest.mark.parametrize("cell", sorted(SIZES))
def test_sound_run_is_correct(cell):
    result = run(cell)
    assert result["correct"] and result["failed"] == 0
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("cell,fault", [(c, f) for c in sorted(SIZES) for f in faults.faults_of(c.split(".")[1])])
def test_fault_is_not_correct(cell, fault):
    with faults.planted(cell.split(".")[1], fault):
        result = run(cell)
    assert not result["correct"] and result["failed"] >= 1, result["checks"]
