"""The control comes out not correct: the plain reference put in the
program's place and computed in bfloat16, the precision below the
configurations' float32, on three seeds at each cell's own size, against
the float32 reference, held to the cell's limits (`checks/<cell>.json`).
On one card, the sharded cell's too (the control renders the whole
frame); `portbench/calibrate.py` prints the same readings beside the
program's. About 5 minutes on an H100, the training cells' float32 and
bfloat16 references most of it."""

import pytest

from portbench import check, spec
from portbench.calibrate import control_numbers, first_step

SEEDS = (4_300_000_001, 4_300_000_002, 4_300_000_003)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["analytical.frames", "sdf.frames", "analytical.train", "sdf.train",
                                  "analytical.sharded-train"])
def test_control_is_not_correct(cuda_device, cell):
    c = spec.resolve(cell)
    for seed in SEEDS:
        want = first = None
        if c.kind.COMPARES == "train":
            first = first_step(c, seed, cuda_device)
            want = check.TrainReference(c.config, c.traffic, int(c.checks["steps"]), seed, cuda_device,
                                        target=first.target if first is not None else None)
        correct, failed, numbers = check.verdict(control_numbers(c, seed, cuda_device, want, first=first),
                                                 c.checks["limits"])
        print(f"{cell} seed {seed}: control {numbers}")  # the readings, with pytest -s
        assert not correct and failed >= 1, (seed, numbers)
