"""The port's inverse rendering held to the JAX package's.

`pathtracer_tpu_torch.integrator.inverse.recover_demo` (eager integrator on
the CPU) against JAX `recover_demo(kernel="xla")`, which draws the same
threefry stream: the analytical demo at 32x16, depth 2, PRNGKey(1). One JAX
run of 4 steps checkpoints every step; the port's 3-step run matches its
first 3 losses and its state after step 3 (trainable leaves and Adam's
moments), and the port resumes from the JAX checkpoint after step 2 to
match steps 3-4 and the recovered leaves. Tolerance rtol 1e-3 (float32, and
torch's and optax's Adam round in another order; Adam magnifies that over
steps, so trajectories are short). `inverse_render` is held to JAX
`inverse_render(kernel="xla")` the same way, once with the paired loss,
the clamp projection and one fixed key, once with the single-render MSE
and fresh keys. The SDF demo (`scene="sdf"`: the sphere and torus radii
and the emission, through the implicit-function gradient of the
sphere-traced hit) is held the same way at 16x8, depth 1 (JAX's compile
of the march's gradient is the cost, ~50 s cold, ~70 s at depth 2): one
JAX run of 4 steps, the port's first 3 steps and its resume from JAX's
step-2 checkpoint.
"""

import os
import shutil

import jax
import numpy as np
import pytest
import torch

from pathtracer_tpu.integrator.inverse import clamp_material_params as jax_clamp_material_params
from pathtracer_tpu.integrator.inverse import inverse_render as jax_inverse_render
from pathtracer_tpu.integrator.inverse import recover_demo as jax_recover_demo
from pathtracer_tpu.integrator.inverse import select_leaves as jax_select_leaves
from pathtracer_tpu.models.analytical import make_scene as jax_make_scene
from pathtracer_tpu.models.sdf import make_scene as jax_make_sdf_scene
from pathtracer_tpu_torch.integrator import inverse as inv
from pathtracer_tpu_torch.models import sdf
from pathtracer_tpu_torch.models.analytical import make_scene
from pathtracer_tpu_torch.ops import rng
from pathtracer_tpu_torch.utils import checkpoint as ck
from pathtracer_tpu_torch.utils.sceneio import invert_state_from_jax
from test_torch_kernel_host import one_torch_thread  # noqa: F401

W, H, DEPTH, SEED = 32, 16, 2, 1
RUN = dict(width=W, height=H, recursion_depth=DEPTH, lr=3e-2, verbose=False)
SDF_RUN = dict(scene="sdf", width=16, height=8, recursion_depth=1, lr=3e-2, verbose=False)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("jax_invert"))
    report = jax_recover_demo(key=jax.random.PRNGKey(SEED), steps=4, kernel="xla", ckpt_dir=d, ckpt_every=1, **RUN)
    return report, d


@pytest.fixture(scope="module")
def jax_sdf_run(tmp_path_factory):
    """JAX's SDF recover_demo, 4 steps, checkpointing every step; its jit
    of the march and its gradient is the cost, paid once per module."""
    d = str(tmp_path_factory.mktemp("jax_invert_sdf"))
    report = jax_recover_demo(key=jax.random.PRNGKey(SEED), steps=4, kernel="xla", ckpt_dir=d, ckpt_every=1,
                              **SDF_RUN)
    return report, d


def test_leaf_names_and_order_match_jax():
    names = [n for n, leaf in inv.named_leaves(make_scene()) if leaf.is_floating_point()]
    _, _, jax_names = jax_select_leaves(jax_make_scene(), ("",))
    assert names == jax_names


def test_sdf_leaf_names_and_order_match_jax():
    names = [n for n, leaf in inv.named_leaves(sdf.make_scene()) if leaf.is_floating_point()]
    _, _, jax_names = jax_select_leaves(jax_make_sdf_scene(), ("",))
    assert names == jax_names


def test_recover_demo_sdf_matches_jax(jax_sdf_run, tmp_path, one_torch_thread):
    """The geometry demo: losses of 3 steps and the state after step 3
    (radii, emission, Adam's moments) against JAX's."""
    jax_report, jax_dir = jax_sdf_run
    report = inv.recover_demo(key=rng.prng_key(SEED), steps=3, kernel="eager", device="cpu",
                              ckpt_dir=str(tmp_path), ckpt_every=1, **SDF_RUN)
    np.testing.assert_allclose(report.losses.numpy(), np.asarray(jax_report.losses)[:3], rtol=1e-3)
    assert [r.name for r in report.rows] == [r.name for r in jax_report.rows] == [
        "params.sphere_radius[0]", "params.torus_major[0]", "lights.emission.x[0]", "lights.emission.y[0]",
        "lights.emission.z[0]"]
    with np.load(os.path.join(jax_dir, "invert_000003.npz")) as want, \
            np.load(str(tmp_path / "invert_000003.npz")) as got:
        n = sum(1 for f in want.files if f.startswith("leaf_"))
        assert n == sum(1 for f in got.files if f.startswith("leaf_")) == 3 * 5 + 2
        for i in range(n):
            np.testing.assert_allclose(got[f"leaf_{i}"], want[f"leaf_{i}"], rtol=1e-3, atol=1e-9, err_msg=f"leaf_{i}")
    # the radii moved: their gradient is the implicit-function one
    assert all(r.recovered != r.start_value for r in report.rows[:2])


def test_resume_from_jax_sdf_checkpoint(jax_sdf_run, tmp_path, one_torch_thread):
    jax_report, jax_dir = jax_sdf_run
    shutil.copy(os.path.join(jax_dir, "invert_000002.npz"), tmp_path)
    report = inv.recover_demo(key=rng.prng_key(SEED), steps=4, kernel="eager", device="cpu",
                              ckpt_dir=str(tmp_path), **SDF_RUN)
    assert report.losses.shape == (2,)
    np.testing.assert_allclose(report.losses.numpy(), np.asarray(jax_report.losses)[2:], rtol=1e-3)
    np.testing.assert_allclose([r.recovered for r in report.rows], [r.recovered for r in jax_report.rows],
                               rtol=1e-3)
    assert (tmp_path / "invert_000004.npz").exists()


def test_recover_demo_matches_jax(jax_run, tmp_path):
    jax_report, jax_dir = jax_run
    report = inv.recover_demo(key=rng.prng_key(SEED), steps=3, kernel="eager", device="cpu",
                              ckpt_dir=str(tmp_path), ckpt_every=1, **RUN)
    np.testing.assert_allclose(report.losses.numpy(), np.asarray(jax_report.losses)[:3], rtol=1e-3)
    with np.load(os.path.join(jax_dir, "invert_000003.npz")) as want, \
            np.load(str(tmp_path / "invert_000003.npz")) as got:
        n = sum(1 for f in want.files if f.startswith("leaf_"))
        assert n == sum(1 for f in got.files if f.startswith("leaf_")) == 3 * 7 + 2
        for i in range(n):
            np.testing.assert_allclose(got[f"leaf_{i}"], want[f"leaf_{i}"], rtol=1e-3, atol=1e-9, err_msg=f"leaf_{i}")


def test_resume_from_jax_checkpoint(jax_run, tmp_path):
    jax_report, jax_dir = jax_run
    shutil.copy(os.path.join(jax_dir, "invert_000002.npz"), tmp_path)
    report = inv.recover_demo(key=rng.prng_key(SEED), steps=4, kernel="eager", device="cpu",
                              ckpt_dir=str(tmp_path), **RUN)
    assert report.losses.shape == (2,)
    np.testing.assert_allclose(report.losses.numpy(), np.asarray(jax_report.losses)[2:], rtol=1e-3)
    assert [r.name for r in report.rows] == [r.name for r in jax_report.rows]
    np.testing.assert_allclose([r.recovered for r in report.rows], [r.recovered for r in jax_report.rows], rtol=1e-3)
    assert (tmp_path / "invert_000004.npz").exists()


@pytest.mark.parametrize("crn,unbiased,clamp,kernel", [(True, True, True, "eager"), (False, False, False, "megakernel")],
                         ids=["paired_crn_clamped", "mse_fresh_keys"])
def test_inverse_render_matches_jax(crn, unbiased, clamp, kernel):
    """inverse_render against JAX inverse_render(kernel="xla") for 3 steps
    toward a grey target, 16x8, depth 2, spp 1: losses and the optimized
    leaves within rtol 1e-3. kernel="megakernel" on a CPU scene is the
    plain version."""
    w, h, select = 16, 8, ("materials.rgb", "lights.emission")
    target = np.full((h, w, 4), 0.5, np.float32)
    run = dict(steps=3, lr=3e-2, spp=1, crn=crn, unbiased=unbiased)
    jax_out = jax_inverse_render(
        jax_make_scene(recursion_depth=DEPTH), jax.numpy.asarray(target), jax.random.PRNGKey(5), select, w, h,
        param_transform=jax_clamp_material_params if clamp else None, kernel="xla", **run,
    )
    out = inv.inverse_render(
        make_scene(recursion_depth=DEPTH), torch.from_numpy(target), rng.prng_key(5), select, w, h,
        param_transform=inv.clamp_material_params if clamp else None, kernel=kernel, **run,
    )
    np.testing.assert_allclose(out.losses.numpy(), np.asarray(jax_out.losses), rtol=1e-3)
    got, _, names = inv.select_leaves(out.scene, select)
    want, _, jax_names = jax_select_leaves(jax_out.scene, select)
    assert names == jax_names
    for name, g, r in zip(names, got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(r), rtol=1e-3, err_msg=name)


def test_megakernel_path_on_cpu_is_the_plain_version():
    a = inv.recover_demo(key=rng.prng_key(2), steps=2, kernel="megakernel", device="cpu", **RUN)
    b = inv.recover_demo(key=rng.prng_key(2), steps=2, kernel="eager", device="cpu", **RUN)
    np.testing.assert_array_equal(a.losses.numpy(), b.losses.numpy())


def test_recover_demo_moves_toward_target():
    """The dimmed light's emission moves toward the true value (as
    tests/test_inverse_demo.py holds the JAX package)."""
    report = inv.recover_demo(key=rng.prng_key(3), steps=10, lr=5e-2, kernel="eager", device="cpu",
                              select=("lights.emission",), width=W, height=H, recursion_depth=DEPTH, verbose=False)
    assert len(report.rows) == 3
    for r in report.rows:
        assert abs(r.recovered - r.true_value) < abs(r.start_value - r.true_value)


def test_port_checkpoint_resumes(tmp_path):
    """A 3-step run equals a 2-step run resumed for 1 more step."""
    full = inv.recover_demo(key=rng.prng_key(4), steps=3, kernel="eager", device="cpu", **RUN)
    inv.recover_demo(key=rng.prng_key(4), steps=2, kernel="eager", device="cpu", ckpt_dir=str(tmp_path), **RUN)
    rest = inv.recover_demo(key=rng.prng_key(4), steps=3, kernel="eager", device="cpu", ckpt_dir=str(tmp_path), **RUN)
    assert rest.losses.shape == (1,)
    np.testing.assert_allclose(rest.losses.numpy(), full.losses.numpy()[2:], rtol=1e-6)
    np.testing.assert_allclose([r.recovered for r in rest.rows], [r.recovered for r in full.rows], rtol=1e-6)


def test_checkpoint_roundtrip_and_structure_mismatch(tmp_path):
    path = str(tmp_path / "ckpt_000001.npz")
    state = ([torch.arange(3.0), torch.tensor(2.5)], (torch.tensor(7), [torch.ones(2)]), torch.tensor(1))
    ck.save_checkpoint(path, state)
    back = ck.load_checkpoint(path, state)
    assert torch.equal(back[0][0], state[0][0]) and float(back[0][1]) == 2.5 and int(back[1][0]) == 7
    assert ck.latest_checkpoint(str(tmp_path)) == path
    assert ck.latest_checkpoint(str(tmp_path / "missing")) is None
    # same leaf count, other structure: refused, never misassigned
    with pytest.raises(ValueError, match="structure"):
        ck.load_checkpoint(path, ([torch.arange(3.0)], (torch.tensor(2.5), torch.tensor(7), [torch.ones(2)]),
                                  torch.tensor(1)))
    with pytest.raises(ValueError, match="shape"):
        ck.load_checkpoint(path, ([torch.arange(4.0), torch.tensor(2.5)], (torch.tensor(7), [torch.ones(2)]),
                                  torch.tensor(1)))
    with pytest.raises(ValueError, match="leaves"):
        ck.load_checkpoint(path, [torch.tensor(1.0)])


def test_jax_state_reader_checks_its_input(jax_run, tmp_path):
    _, jax_dir = jax_run
    path = os.path.join(jax_dir, "invert_000002.npz")
    train, _, _ = inv.select_leaves(make_scene(), ("materials.rgb", "materials.roughness", "lights.emission"))
    vals, (count, mu, nu), step = invert_state_from_jax(path, train)
    assert count == 2 and step == 2 and len(vals) == len(mu) == len(nu) == 7
    with pytest.raises(ValueError, match="leaves"):
        invert_state_from_jax(path, train[:-1])
    own = str(tmp_path / "own.npz")
    ck.save_checkpoint(own, (train, (torch.tensor(1), train, train), torch.tensor(1)))
    with pytest.raises(ValueError, match="optax"):
        invert_state_from_jax(own, train)


def test_recover_demo_refuses_what_is_not_ported():
    with pytest.raises(NotImplementedError):
        inv.recover_demo(mesh=object(), device="cpu", steps=1, width=8, height=8, verbose=False)
    with pytest.raises(ValueError):
        inv.recover_demo(kernel="pallas", device="cpu", steps=1, width=8, height=8, verbose=False)
