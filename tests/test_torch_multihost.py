"""The port's kill-and-restart drill (`pathtracer_tpu_torch/parallel/
launch.run_demo_ckpt`) on 2 CPU ranks (gloo), and a JAX drill's
checkpoint carried across.

Rank 0 dies (os._exit(17)) after step 2 of 4; the survivor's next
collective fails within the group's timeout; a restart of the whole job
resumes from the newest mh_ checkpoint and its final loss is the
uninterrupted run's bit for bit, on every rank. A restart after the last
step returns the same loss without a step and leaves the last checkpoint
as it was (the JAX job steps the final state once more and overwrites
it, a fault the port does not copy). The JAX package's run_demo_ckpt
checkpoint after step 2 (tests/golden_torch/parallel/mh_0002.npz, written
by tests/torch_parallel_jax.py) resumes in the port and reaches JAX's
uninterrupted final loss within rtol 1e-5.

Every spawn has a time limit, and the group a timeout for each
collective (pathtracer_tpu_torch/tools/rank_jobs.py), so nothing here
can hang.
"""

import pathlib
import shutil
import time

import numpy as np
import pytest

from pathtracer_tpu_torch.parallel import launch
from pathtracer_tpu_torch.tools.rank_jobs import GROUP_TIMEOUT, ROOT, result, spawn
from test_torch_kernel_host import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

FIXTURES = pathlib.Path(ROOT) / "tests" / "golden_torch" / "parallel"
STEPS = 4


def _run(directory, ckpt, die_after=None):
    return spawn(directory, 2, "drill", steps=STEPS, ckpt_dir=str(ckpt), die_after=die_after)


def _losses(directory, runs) -> list:
    for rank, (rc, out, err) in enumerate(runs):
        assert rc == 0, f"rank {rank} failed ({rc}):\n{out}\n{err[-4000:]}"
    return [result(directory, "drill", r)["loss"] for r in range(len(runs))]


@pytest.fixture(scope="module")
def drill(tmp_path_factory):
    """The uninterrupted run, the run whose rank 0 dies after step 2, and
    the restart of the latter: their outputs, losses and checkpoints."""
    d = tmp_path_factory.mktemp("drill")
    ref, ckpt = d / "ref", d / "drill"
    ref_runs = _run(d, ref)
    ref_losses = _losses(d, ref_runs)
    t0 = time.perf_counter()
    died = _run(d, ckpt, die_after=2)
    died_s = time.perf_counter() - t0
    after_death = sorted(p.name for p in ckpt.iterdir())
    restart = _run(d, ckpt)
    return {"dir": d, "ref": ref, "ref_runs": ref_runs, "ref_losses": ref_losses, "died": died, "died_s": died_s,
            "after_death": after_death, "restart": restart, "restart_losses": _losses(d, restart)}


def test_rank_zero_dies_and_the_survivor_fails(drill):
    """Rank 0 exits 17 after step 2; rank 1's next collective fails well
    within the group's timeout; mh_0002 is the newest checkpoint."""
    (rc0, out0, _), (rc1, _, err1) = drill["died"]
    assert rc0 == 17, out0
    assert rc1 != 0, err1
    assert drill["died_s"] < GROUP_TIMEOUT + 60
    assert "mh_0002.npz" in drill["after_death"] and "mh_0003.npz" not in drill["after_death"]


def test_restart_resumes_to_the_uninterrupted_loss(drill):
    """The restarted job resumes from mh_0002 and ends on the uninterrupted
    run's loss bit for bit, on every rank."""
    assert "resumed from" in drill["restart"][0][1] and "at step 2" in drill["restart"][0][1]
    ref = drill["ref_losses"]
    assert ref[0] == ref[1]
    assert drill["restart_losses"] == ref


def test_restart_after_the_last_step_takes_no_step(drill):
    """A restart of the finished run returns its final loss from mh_0004,
    takes no step (no step line, no mh_0005) and leaves mh_0004 as it was
    (the fault of the JAX job's clamp, which the port does not copy)."""
    last = drill["ref"] / f"mh_{STEPS:04d}.npz"
    before = last.read_bytes()
    runs = _run(drill["dir"], drill["ref"])
    assert _losses(drill["dir"], runs) == drill["ref_losses"]
    assert last.read_bytes() == before
    assert not (drill["ref"] / f"mh_{STEPS + 1:04d}.npz").exists()
    assert "step" not in runs[0][1].replace("at step", "")


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    """The JAX run_demo_ckpt's mh_0002.npz (optax's Adam state) resumes
    here: the port takes steps 2 and 3 and ends within rtol 1e-5 of JAX's
    uninterrupted final loss, writing its own mh_0003 and mh_0004."""
    shutil.copy(FIXTURES / "mh_0002.npz", tmp_path / "mh_0002.npz")
    logs = []
    loss = launch.run_demo_ckpt(width=32, height=16, steps=STEPS, ckpt_dir=str(tmp_path), device="cpu",
                                log=logs.append)
    assert any("resumed from" in line and "at step 2" in line for line in logs)
    with np.load(FIXTURES / "parallel_jax.npz") as jax_results:
        np.testing.assert_allclose(loss, float(jax_results["run_demo_ckpt_loss"]), rtol=1e-5)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["mh_0002.npz", "mh_0003.npz", "mh_0004.npz"]
