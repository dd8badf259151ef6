"""The port's sharding (`pathtracer_tpu_torch/parallel/mesh.py`) held to
itself unsharded and to the JAX package's, on the CPU.

The rank layout and factor_mesh against JAX's make_mesh and factor_mesh;
shard_ranges' cover of a frame; the eager tier over a range against the
whole frame. Then process groups of CPU processes (gloo, started together
in one module fixture): 2 ranks (2x1) and 4 (2x2) at 32x16, their ranges
aligned to K2's 128-pixel blocks (`pathtracer_tpu_torch/tools/
rank_jobs.py` spawns them and runs their jobs). The sharded frames equal
the port's single render (bit for bit; the eager tier's spp mean over two sample
groups within JAX's own tolerance, tests/test_parallel.py) and JAX's
render_frame_sharded on its virtual 8-device mesh (float64, atol 1e-6);
the sharded training step's losses are equal on every rank and its leaves
within rtol 1e-5 of one rank's; run_demo's final loss is JAX's within
rtol 1e-5; recover_demo(mesh=) follows the one-rank report; and the
render CLI with --mesh 2x1 on 2 ranks under torch.distributed.run writes
the 1x1 run's PNG byte for byte.

No JAX render runs here but the layout's: the JAX results are committed
under tests/golden_torch/parallel/ (`python tests/test_torch_parallel.py`
writes them again through tests/torch_parallel_jax.py; the `slow` guard
checks that they are still what JAX computes). The JAX frames are float64:
JAX on the CPU contracts FMAs, which puts its float32 frame 9.3e-6 from
the port's at spp 4.
"""

import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from pathtracer_tpu.parallel import mesh as jax_mesh
from pathtracer_tpu_torch.app import invert as invert_cli
from pathtracer_tpu_torch.app import render as cli
from pathtracer_tpu_torch.integrator import inverse
from pathtracer_tpu_torch.integrator import tracer as T
from pathtracer_tpu_torch.models import mesh as mesh_scene
from pathtracer_tpu_torch.models import sdf
from pathtracer_tpu_torch.models.analytical import make_scene
from pathtracer_tpu_torch.ops import megakernel as MK
from pathtracer_tpu_torch.ops import rng
from pathtracer_tpu_torch.parallel import launch
from pathtracer_tpu_torch.parallel import mesh as M
from pathtracer_tpu_torch.tools.rank_jobs import ROOT, SPAWN_TIMEOUT, child_env, finish, result, start, train_steps
from test_torch_kernel_host import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

FIXTURES = pathlib.Path(ROOT) / "tests" / "golden_torch" / "parallel"
JAX_SCRIPT = pathlib.Path(ROOT) / "tests" / "torch_parallel_jax.py"
W, H = 32, 16
SIZE = dict(width=W, height=H)
# the jobs of each process group: {name: [job, kwargs]}
TWO = {
    "render_d4": ["render", dict(tiles=2, n_spp=1, spp=1, depth=4, **SIZE)],
    "render_d4_f64": ["render", dict(tiles=2, n_spp=1, spp=1, depth=4, dtype="float64", **SIZE)],
    "train_eager": ["train", dict(tiles=2, n_spp=1, kernel="eager", spp=1, **SIZE)],
    "train_megakernel": ["train", dict(tiles=2, n_spp=1, kernel="megakernel", spp=1, **SIZE)],
    "run_demo": ["run_demo", {}],
    "recover_megakernel": ["recover", dict(kernel="megakernel", **SIZE)],
    "recover_eager": ["recover", dict(kernel="eager", **SIZE)],
}
FOUR = {
    "render_d3_spp4": ["render", dict(tiles=2, n_spp=2, spp=4, depth=3, **SIZE)],
    "render_d3_spp4_f64": ["render", dict(tiles=2, n_spp=2, spp=4, depth=3, dtype="float64", **SIZE)],
    "train_eager": ["train", dict(tiles=2, n_spp=2, kernel="eager", spp=2, **SIZE)],
    "train_megakernel": ["train", dict(tiles=2, n_spp=2, kernel="megakernel", spp=2, **SIZE)],
}
CLI_ARGS = ["--device", "cpu", "--width", "64", "--height", "48", "--depth", "3", "--frames", "2"]


def _check(label: str, runs: list) -> None:
    for rank, (rc, out, err) in enumerate(runs):
        assert rc == 0, f"{label} rank {rank} failed ({rc}):\n{out}\n{err[-4000:]}"


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """Both process groups' results (2x1 and 2x2), and the render CLI's
    PNG from 2 ranks under torch.distributed.run, all started together:
    {"two": [rank results], "four": [...], "cli_png": path}."""
    dirs = {name: tmp_path_factory.mktemp(name) for name in ("two", "four", "cli")}
    png = dirs["cli"] / "mesh.png"
    running = {
        "two": start(dirs["two"], 2, "parts", parts=TWO),
        "four": start(dirs["four"], 4, "parts", parts=FOUR),
        "cli": [subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2", "-m",
             "pathtracer_tpu_torch.app.render", *CLI_ARGS, "--mesh", "2x1", "-o", str(png)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=child_env(), cwd=ROOT)],
    }
    out = {}
    for name, procs in running.items():
        runs = finish(procs, SPAWN_TIMEOUT)
        _check(name, runs)
        out[name] = runs if name == "cli" else [result(dirs[name], "parts", r) for r in range(len(runs))]
    out["cli_png"] = png
    return out


@pytest.fixture(scope="module")
def jax_results():
    with np.load(FIXTURES / "parallel_jax.npz") as data:
        return {k: data[k] for k in data.files}


# (a) the layout


@pytest.mark.parametrize("n,n_spp", [(1, None), (2, None), (3, None), (4, None), (6, None), (8, None), (8, 1),
                                     (8, 4), (6, 3)])
def test_factor_matches_jax_factor_mesh(n, n_spp):
    want = jax_mesh.factor_mesh(n, jax.devices()[:n], n_spp=n_spp).shape
    assert M.factor(n, n_spp) == (want["tiles"], want["spp"])


@pytest.mark.parametrize("n,n_spp", [(8, 3), (6, 4), (4, 0)])
def test_factor_refuses_what_jax_refuses(n, n_spp):
    with pytest.raises(ValueError, match="positive divisor"):
        jax_mesh.factor_mesh(n, jax.devices()[:n], n_spp=n_spp)
    with pytest.raises(ValueError, match="positive divisor"):
        M.factor(n, n_spp)


@pytest.mark.parametrize("tiles,n_spp", [(4, 2), (2, 4), (8, 1), (1, 8), (2, 2)])
def test_rank_layout_matches_jax_make_mesh(tiles, n_spp):
    devices = jax.devices()[:tiles * n_spp]
    want = np.vectorize(devices.index)(jax_mesh.make_mesh(tiles, n_spp, devices).devices)
    layout = M.rank_layout(tiles, n_spp)
    assert np.array_equal(layout, want)
    for r in range(tiles * n_spp):
        m = M.Mesh(tiles, n_spp, r)
        assert layout[m.tile, m.sample_group] == r


@pytest.mark.parametrize("n,ranks", [(512, 2), (512, 4), (512, 8), (6500, 8), (1920 * 1080, 2), (1920 * 1080, 3),
                                     (100, 3), (0, 2)])
def test_shard_ranges_cover_the_frame(n, ranks):
    """Contiguous, in rank order, aligned, covering every pixel once; the
    ranks past the frame (JAX's 100x65 frame over 8 devices,
    tests/test_parallel_pallas.py) get an empty range at its end."""
    got = M.shard_ranges(n, ranks)
    assert len(got) == ranks
    at = 0
    for begin, count in got:
        assert begin == at and count >= 0
        if count == 0:
            assert begin == n
        else:
            assert begin % M.RANGE_ALIGN == 0 and (count % M.RANGE_ALIGN == 0 or begin + count == n)
        at = begin + count
    assert at == n


def test_shard_ranges_refuse_no_ranks():
    with pytest.raises(ValueError, match="0 ranks"):
        M.shard_ranges(512, 0)


def test_rank_device_refuses_a_missing_card(monkeypatch):
    """Without initialize(), a rank's device is its card, and a host
    without one raises: a library entry (run_demo, run_demo_ckpt) runs on
    the CPU only where the caller passes device="cpu"."""
    monkeypatch.setattr(launch, "_DEVICE", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launch.rank_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launch.run_demo(width=W, height=H, steps=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launch.initialize(world_size=1, rank=0, log=lambda s: None)


def _scenes():
    """name -> (scene, spp); the eager SDF march is the slow one."""
    return {"analytical": (make_scene(recursion_depth=4), 2), "analytical_f64": (make_scene(dtype=torch.float64), 2),
            "sdf": (sdf.make_scene(recursion_depth=2), 1), "mesh": (mesh_scene.make_scene(recursion_depth=3), 2)}


@pytest.mark.parametrize("name", ["analytical", "analytical_f64", "sdf", "mesh"])
def test_eager_range_equals_whole_frame(name):
    """The eager tier over each rank's range of 2, 3 and 8 ranks (aligned
    to 128; 8 leaves two ranks an empty range) gives the whole frame's
    pixels bit for bit (spp 2; the SDF scene spp 1) and zeros elsewhere;
    its K3 plain counts too. (Unaligned ranges may move the last ulp:
    torch's CPU atan2 and pow round their vector loop's scalar tail
    apart.)"""
    (scene, spp), key, w, h = _scenes()[name], rng.prng_key(5), 40, 19
    n = w * h
    whole = T.render_frame(scene, key, w, h, spp=spp).reshape(-1, 4)
    counts = T.bounces_entered(scene, key, w, h, spp).reshape(spp, -1)
    for ranks in (2, 3, 8):
        for begin, count in M.shard_ranges(n, ranks):
            img = T.render_frame(scene, key, w, h, spp=spp, pixels=(begin, count)).reshape(-1, 4)
            assert torch.equal(img[begin:begin + count], whole[begin:begin + count])
            assert not img[:begin].any() and not img[begin + count:].any()
            entered = T.bounces_entered(scene, key, w, h, spp, pixels=(begin, count)).reshape(spp, -1)
            assert torch.equal(entered[:, begin:begin + count], counts[:, begin:begin + count])
            assert not entered[:, :begin].any() and not entered[:, begin + count:].any()


def test_cpu_megakernel_range_is_its_plain_version():
    """render_frame_megakernel and K2's plain version over a range on the
    CPU: the range's pixels of the whole frame, and the gradient of those
    pixels only; a range outside the frame raises."""
    scene, key = make_scene(recursion_depth=3), rng.prng_key(6)
    n, pixels = 24 * 16, (128, 128)
    whole = MK.render_frame_megakernel(scene, key, 24, 16).reshape(-1, 4)
    part = MK.render_frame_megakernel(scene, key, 24, 16, pixels=pixels).reshape(-1, 4)
    assert torch.equal(part[128:256], whole[128:256]) and not part[:128].any() and not part[256:].any()
    sv = MK.pack_scene(scene, 24, 16)
    ct = torch.from_numpy(np.random.default_rng(3).standard_normal((16, 24, 4)).astype(np.float32))
    masked = ct.clone().reshape(-1, 4)
    masked[:128], masked[256:] = 0, 0
    got = MK.render_grad_reference(sv, scene, key, ct, 24, 16, pixels=pixels)
    want = MK.render_grad_reference(sv, scene, key, masked.reshape(16, 24, 4), 24, 16)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-7)
    with pytest.raises(ValueError, match="outside a frame"):
        MK.render_frame_megakernel(scene, key, 24, 16, pixels=(300, n))


def test_make_mesh_refuses_another_world_size():
    assert M.make_mesh(1, 1).size == 1
    with pytest.raises(ValueError, match="2x2 mesh needs 4 ranks, the process group has 1"):
        M.make_mesh(2, 2)


@pytest.mark.parametrize("text,want", [("4x2", (4, 2)), ("2X1", (2, 1)), ("4", (4, 1)), ("1x1", (1, 1))])
def test_cli_mesh_parses_as_jax(text, want):
    assert M.parse_mesh(text) == want
    cfg, _ = cli.parse_args(["--mesh", text])
    assert (cfg.mesh_tiles, cfg.mesh_spp) == want and cfg.sharded == (want != (1, 1))


def test_clis_refuse_a_mesh_that_is_not_the_world(tmp_path):
    """--mesh 2x1 in a process group of one rank raises before the first
    frame (no PNG) and before the first step."""
    cfg, out = cli.parse_args([*CLI_ARGS, "--mesh", "2x1", "-o", str(tmp_path / "x.png")])
    with pytest.raises(ValueError, match="2x1 mesh needs 2 ranks"):
        cli.render(cfg, out, log=lambda s: None)
    assert not (tmp_path / "x.png").exists()
    with pytest.raises(ValueError, match="1x2 mesh needs 2 ranks"):
        invert_cli.main(["--device", "cpu", "--width", "8", "--height", "8", "--steps", "1", "--mesh", "1x2"],
                        log=lambda s: None)


# (b) process groups


def _same_on_every_rank(ranks: list, name: str, key: str):
    first = ranks[0][name][key]
    for other in ranks[1:]:
        assert torch.equal(other[name][key], first) if torch.is_tensor(first) else other[name][key] == first
    return first


@pytest.mark.parametrize("kernel", ["eager", "megakernel"])
def test_sharded_render_2x1_equals_single(groups, kernel):
    """2 ranks, spp 1, depth 4: the sharded frame is the single render's
    bit for bit, on every rank (each rank renders 256 pixels)."""
    frame = _same_on_every_rank(groups["two"], "render_d4", kernel)
    scene, key = make_scene(recursion_depth=4), rng.prng_key(3)
    want = T.render_frame(scene, key, W, H) if kernel == "eager" else MK.render_frame_megakernel(scene, key, W, H)
    assert torch.equal(frame, want)
    assert [r["render_d4"]["flat_pixels"] for r in groups["two"]] == [(0, 256), (256, 256)]


@pytest.mark.parametrize("kernel", ["eager", "megakernel"])
def test_sharded_render_2x2_spp4(groups, kernel):
    """2x2 ranks, spp 4, depth 3: the megakernel path (every rank a range
    of 128 pixels with all 4 samples) is the single render's bit for bit;
    the eager tier (2 tiles of 256 pixels, 2 sample groups of 2) sums the
    groups' means in another order, within JAX's tolerance for its own."""
    frame = _same_on_every_rank(groups["four"], "render_d3_spp4", kernel)
    scene, key = make_scene(recursion_depth=3), rng.prng_key(3)
    if kernel == "megakernel":
        assert torch.equal(frame, MK.render_frame_megakernel(scene, key, W, H, 4))
    else:
        torch.testing.assert_close(frame, T.render_frame(scene, key, W, H, spp=4), rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("group,name,fixture", [("two", "render_d4_f64", "sharded_8x1_spp1_d4"),
                                                ("four", "render_d3_spp4_f64", "sharded_4x2_spp4_d3")])
@pytest.mark.parametrize("kernel", ["eager", "megakernel"])
def test_sharded_render_matches_jax(groups, jax_results, group, name, fixture, kernel):
    """The float64 sharded frames against JAX's render_frame_sharded on the
    8-device mesh (8x1 at spp 1, 4x2 at spp 4): atol 1e-6."""
    frame = _same_on_every_rank(groups[group], name, kernel)
    np.testing.assert_allclose(frame.numpy(), jax_results[fixture], rtol=0, atol=1e-6)


@pytest.mark.parametrize("group", ["two", "four"])
@pytest.mark.parametrize("kernel", ["eager", "megakernel"])
def test_sharded_train_step_matches_one_rank(groups, group, kernel):
    """Three sharded steps of recover_demo's analytical leaves: the loss is
    the same on every rank, and the losses and the leaves are one rank's
    (a 1x1 mesh) within rtol 1e-5 (the gradients add up in another
    order)."""
    name = f"train_{kernel}"
    losses = _same_on_every_rank(groups[group], name, "losses")
    spp = FOUR[name][1]["spp"] if group == "four" else 1
    one = train_steps(M.make_mesh(1, 1), kernel, W, H, spp)
    np.testing.assert_allclose(losses, one["losses"], rtol=1e-5)
    for rank in groups[group]:
        for got, want in zip(rank[name]["leaves"], one["leaves"]):
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-7)


def test_run_demo_matches_jax(groups, jax_results):
    """run_demo at its defaults (64x32, 4 steps) on 2 ranks against the JAX
    package's on 8 devices: rtol 1e-5 (3.8e-7 apart when written)."""
    loss = _same_on_every_rank(groups["two"], "run_demo", "loss")
    np.testing.assert_allclose(loss, float(jax_results["run_demo_loss"]), rtol=1e-5)


@pytest.mark.parametrize("kernel", ["megakernel", "eager"])
def test_recover_demo_mesh_matches_one_rank(groups, kernel):
    """recover_demo(mesh=) on 2 ranks, 3 steps at 32x16, against the
    one-rank report: the losses and every recovered value within rtol
    1e-5, the same on both ranks."""
    name = f"recover_{kernel}"
    losses = _same_on_every_rank(groups["two"], name, "losses")
    recovered = _same_on_every_rank(groups["two"], name, "recovered")
    one = inverse.recover_demo(width=W, height=H, steps=3, kernel=kernel, device="cpu", verbose=False)
    torch.testing.assert_close(losses, one.losses, rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(recovered, [r.recovered for r in one.rows], rtol=1e-5, atol=1e-7)


def test_render_cli_mesh_2x1_writes_the_1x1_png(groups, tmp_path):
    """The render CLI with --mesh 2x1 on 2 CPU ranks under
    torch.distributed.run (64x48: 1536 pixels a rank) writes the PNG of
    the unsharded run byte for byte; rank 0 alone writes."""
    png = tmp_path / "single.png"
    cfg, out = cli.parse_args([*CLI_ARGS, "-o", str(png)])
    cli.render(cfg, out, log=lambda s: None)
    assert groups["cli_png"].read_bytes() == png.read_bytes()
    out = groups["cli"][0][1]
    assert out.count("wrote ") == 1 and "backend gloo" in out


@pytest.mark.slow
def test_jax_fixtures_are_current(tmp_path):
    """tests/golden_torch/parallel/ is what the JAX package computes today."""
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
           "PYTHONPATH": ROOT}
    subprocess.run([sys.executable, str(JAX_SCRIPT), str(tmp_path)], check=True, env=env, timeout=900)
    for name in ("parallel_jax.npz", "mh_0002.npz"):
        with np.load(tmp_path / name) as got, np.load(FIXTURES / name) as want:
            assert sorted(got.files) == sorted(want.files)
            for f in got.files:
                np.testing.assert_array_equal(got[f], want[f])


if __name__ == "__main__":
    subprocess.run([sys.executable, str(JAX_SCRIPT), str(FIXTURES)], check=True, env={
        **os.environ, "JAX_PLATFORMS": "cpu", "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
        "PYTHONPATH": ROOT})
