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

The mesh's vertex recovery (`inverse_render` on the demo mesh from a
start with the pyramid's apex raised from y 0.9 to 1.25 and the light's
emission x 0.45, selecting the vertices' y and the emission, lr 3e-2, spp
1, toward JAX's render of the demo mesh) is held to JAX
`inverse_render(kernel="xla")` at 32x16, depth 2, PRNGKey(3): the losses
of 3 steps and the leaves after them, rtol 1e-3. JAX runs it op by op
(`jax.disable_jit`): XLA's compile of the mesh's gradient outgrows 10 GB
of host memory.

The JAX runs are committed: tests/golden_torch/invert_analytical_32x16_d2_k1/
and invert_sdf_16x8_d1_k1/ (JAX's checkpoints after steps 2 and 3, and
report.npz with the losses and the recovered leaves),
inverse_render_16x8_d2_k5.npz and invert_mesh_32x16_d2_k3.npz (the
target, the losses and the leaves). Regenerate them with
`JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_inverse.py` (about
four minutes); their guard is marked `slow`.
"""

import os
import shutil
import types

import jax
import numpy as np

import pathtracer_tpu as pt
import pytest
import torch

from pathtracer_tpu.integrator.inverse import clamp_material_params as jax_clamp_material_params
from pathtracer_tpu.integrator.inverse import inverse_render as jax_inverse_render
from pathtracer_tpu.integrator.inverse import recover_demo as jax_recover_demo
from pathtracer_tpu.integrator.inverse import select_leaves as jax_select_leaves
from pathtracer_tpu.models.analytical import make_scene as jax_make_scene
from pathtracer_tpu.models.mesh import make_scene as jax_make_mesh_scene
from pathtracer_tpu.models.sdf import make_scene as jax_make_sdf_scene
from pathtracer_tpu_torch.integrator import inverse as inv
from pathtracer_tpu_torch.models import mesh, sdf
from pathtracer_tpu_torch.models.analytical import make_scene
from pathtracer_tpu_torch.ops import rng
from pathtracer_tpu_torch.utils import checkpoint as ck
from pathtracer_tpu_torch.utils.sceneio import invert_state_from_jax
from test_torch_kernel_host import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

W, H, DEPTH, SEED = 32, 16, 2, 1
RUN = dict(width=W, height=H, recursion_depth=DEPTH, lr=3e-2, verbose=False)
SDF_RUN = dict(scene="sdf", width=16, height=8, recursion_depth=1, lr=3e-2, verbose=False)


GOLDEN = os.path.join(os.path.dirname(__file__), "golden_torch")
# family -> (the JAX run, the committed directory of its fixture)
JAX_RUNS = {
    "analytical": (RUN, os.path.join(GOLDEN, "invert_analytical_32x16_d2_k1")),
    "sdf": (SDF_RUN, os.path.join(GOLDEN, "invert_sdf_16x8_d1_k1")),
}
INVERSE_RENDER_FIXTURE = os.path.join(GOLDEN, "inverse_render_16x8_d2_k5.npz")
INVERSE_RENDER_CASES = {
    "paired_crn_clamped": dict(crn=True, unbiased=True, clamp=True, kernel="eager"),
    "mse_fresh_keys": dict(crn=False, unbiased=False, clamp=False, kernel="megakernel"),
}
INVERSE_RENDER_SELECT = ("materials.rgb", "lights.emission")
MESH_FIXTURE = os.path.join(GOLDEN, "invert_mesh_32x16_d2_k3.npz")


def jax_recover(family: str, directory: str) -> None:
    """JAX's recover_demo of `family`, 4 steps from PRNGKey(SEED),
    checkpointing every step into `directory`: keeps the checkpoints after
    steps 2 and 3 and writes report.npz (the losses, and each row's name
    and recovered value)."""
    run, _ = JAX_RUNS[family]
    report = jax_recover_demo(key=jax.random.PRNGKey(SEED), steps=4, kernel="xla", ckpt_dir=directory,
                              ckpt_every=1, **run)
    for step in (1, 4):
        os.remove(os.path.join(directory, f"invert_{step:06d}.npz"))
    np.savez(os.path.join(directory, "report.npz"), losses=np.asarray(report.losses),
             names=np.array([r.name for r in report.rows]), recovered=np.array([r.recovered for r in report.rows]))


def _committed_run(family: str):
    directory = JAX_RUNS[family][1]
    with np.load(os.path.join(directory, "report.npz")) as data:
        report = types.SimpleNamespace(losses=data["losses"], names=data["names"].tolist(),
                                       recovered=data["recovered"])
    return report, directory


@pytest.fixture(scope="module")
def jax_run():
    """JAX's analytical recover_demo, 4 steps, checkpointing every step, as
    committed (test_jax_fixtures_are_what_jax_computes guards them)."""
    return _committed_run("analytical")


@pytest.fixture(scope="module")
def jax_sdf_run():
    """JAX's SDF recover_demo as committed: its jit of the march and its
    gradient takes ~30-50 s, which the guard pays under `slow`."""
    return _committed_run("sdf")


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
    assert [r.name for r in report.rows] == jax_report.names == [
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
    np.testing.assert_allclose([r.recovered for r in report.rows], jax_report.recovered, rtol=1e-3)
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
    assert [r.name for r in report.rows] == jax_report.names
    np.testing.assert_allclose([r.recovered for r in report.rows], jax_report.recovered, rtol=1e-3)
    assert (tmp_path / "invert_000004.npz").exists()


def jax_inverse_render_runs() -> dict:
    """JAX inverse_render(kernel="xla") for 3 steps toward a grey target,
    16x8, depth 2, spp 1, PRNGKey(5), in each case: "<case>.losses" and
    "<case>.<leaf name>" for the optimized leaves."""
    w, h = 16, 8
    target = jax.numpy.full((h, w, 4), 0.5, jax.numpy.float32)
    out = {}
    for case, c in INVERSE_RENDER_CASES.items():
        res = jax_inverse_render(
            jax_make_scene(recursion_depth=DEPTH), target, jax.random.PRNGKey(5), INVERSE_RENDER_SELECT, w, h,
            param_transform=jax_clamp_material_params if c["clamp"] else None, kernel="xla", steps=3, lr=3e-2,
            spp=1, crn=c["crn"], unbiased=c["unbiased"],
        )
        out[f"{case}.losses"] = np.asarray(res.losses)
        want, _, names = jax_select_leaves(res.scene, INVERSE_RENDER_SELECT)
        out.update({f"{case}.{name}": np.asarray(r) for name, r in zip(names, want)})
    return out


@pytest.mark.parametrize("case", list(INVERSE_RENDER_CASES))
def test_inverse_render_matches_jax(case):
    """inverse_render against JAX inverse_render(kernel="xla") as committed
    in tests/golden_torch/inverse_render_16x8_d2_k5.npz: losses and the
    optimized leaves within rtol 1e-3. kernel="megakernel" on a CPU scene is
    the plain version."""
    c = INVERSE_RENDER_CASES[case]
    w, h = 16, 8
    out = inv.inverse_render(
        make_scene(recursion_depth=DEPTH), torch.full((h, w, 4), 0.5), rng.prng_key(5), INVERSE_RENDER_SELECT, w, h,
        param_transform=inv.clamp_material_params if c["clamp"] else None, kernel=c["kernel"], steps=3, lr=3e-2,
        spp=1, crn=c["crn"], unbiased=c["unbiased"],
    )
    got, _, names = inv.select_leaves(out.scene, INVERSE_RENDER_SELECT)
    with np.load(INVERSE_RENDER_FIXTURE) as want:
        np.testing.assert_allclose(out.losses.numpy(), want[f"{case}.losses"], rtol=1e-3)
        assert sorted(f"{case}.{n}" for n in names) == sorted(k for k in want.files if k.startswith(case + ".")
                                                               and k != f"{case}.losses")
        for name, g in zip(names, got):
            np.testing.assert_allclose(g.detach().numpy(), want[f"{case}.{name}"], rtol=1e-3, err_msg=name)


@pytest.mark.slow
def test_jax_fixtures_are_what_jax_computes(tmp_path):
    """The committed JAX runs above, run again (about two minutes: JAX's
    compile of the SDF trainer's gradient). rtol 1e-5 with the port tests'
    atol 1e-9: two JAX runs of the trainer on the CPU, one compiled afresh
    and one from the compile cache, differed by 2.6e-6 in a leaf after
    Adam's steps, and by 1.3e-10 in a second moment of 1.2e-6."""
    for family, (_, directory) in JAX_RUNS.items():
        d = tmp_path / family
        d.mkdir()
        jax_recover(family, str(d))
        for name in sorted(os.listdir(directory)):
            with np.load(os.path.join(directory, name)) as want, np.load(str(d / name)) as got:
                assert sorted(got.files) == sorted(want.files), name
                for k in want.files:
                    if want[k].dtype.kind in "fc":
                        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-9, err_msg=f"{name} {k}")
                    else:
                        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{name} {k}")
    with np.load(INVERSE_RENDER_FIXTURE) as want:
        got = jax_inverse_render_runs()
        assert sorted(got) == sorted(want.files)
        for k in want.files:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    with np.load(MESH_FIXTURE) as want:  # op by op: bit for bit
        got = jax_mesh_inverse_render()
        assert sorted(got) == sorted(want.files)
        for k in want.files:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def jax_mesh_inverse_render() -> dict:
    """JAX inverse_render(kernel="xla") of the mesh's vertex recovery, 3
    steps at 32x16, depth 2, PRNGKey(3), toward JAX's render of the demo
    mesh (PRNGKey(17)); op by op. Returns the target, the losses and the
    optimized leaves by name."""
    true = jax_make_mesh_scene(recursion_depth=DEPTH)
    p, lights = true.params, true.lights
    start = true.replace(
        params=p._replace(vertices=p.vertices._replace(y=p.vertices.y.at[inv.MESH_APEX].set(inv.MESH_APEX_Y))),
        lights=lights._replace(emission=lights.emission._replace(
            **{c: getattr(lights.emission, c) * inv.MESH_DIM for c in "xyz"})),
    )
    with jax.disable_jit():
        target = pt.render_frame(true, jax.random.PRNGKey(17), W, H)
        res = jax_inverse_render(start, target, jax.random.PRNGKey(3), inv.MESH_SELECT, W, H, kernel="xla",
                                 steps=3, lr=3e-2, spp=1)
    want, _, names = jax_select_leaves(res.scene, inv.MESH_SELECT)
    return {"target": np.asarray(target), "losses": np.asarray(res.losses),
            **{name: np.asarray(r) for name, r in zip(names, want)}}


def test_mesh_inverse_render_matches_jax():
    """The eager mesh trainer, 3 steps of the paired loss, against JAX's as
    committed: the losses and the vertices' y and the emission after them
    within rtol 1e-3; the dimmed emission grows toward the truth."""
    with np.load(MESH_FIXTURE) as data:
        want = {k: data[k] for k in data.files}
    start = inv.mesh_start_scene(mesh.make_scene(recursion_depth=DEPTH))
    out = inv.inverse_render(start, torch.from_numpy(want["target"]), rng.prng_key(3), inv.MESH_SELECT, W, H,
                             steps=3, lr=3e-2, spp=1, kernel="eager")
    np.testing.assert_allclose(out.losses.numpy(), want["losses"], rtol=1e-3)
    got, _, names = inv.select_leaves(out.scene, inv.MESH_SELECT)
    assert sorted(names + ["losses", "target"]) == sorted(want)
    for name, g in zip(names, got):
        np.testing.assert_allclose(g.detach().numpy(), want[name], rtol=1e-3, atol=1e-9, err_msg=name)
    assert all(float(c) > 3.0 * inv.MESH_DIM for c in out.scene.lights.unpack().emission)


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
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):  # mesh= is ported: it takes a Mesh
        inv.recover_demo(mesh=object(), device="cpu", steps=1, width=8, height=8, verbose=False)
    with pytest.raises(ValueError):
        inv.recover_demo(kernel="pallas", device="cpu", steps=1, width=8, height=8, verbose=False)
    for scene in ("mesh", "bigmesh"):
        with pytest.raises(NotImplementedError, match="ROADMAP item 12"):
            inv.recover_demo(scene=scene, device="cpu", steps=1, width=8, height=8, verbose=False)


if __name__ == "__main__":
    for fam, (_, directory) in JAX_RUNS.items():
        os.makedirs(directory, exist_ok=True)
        jax_recover(fam, directory)
    np.savez(INVERSE_RENDER_FIXTURE, **jax_inverse_render_runs())
    np.savez(MESH_FIXTURE, **jax_mesh_inverse_render())
