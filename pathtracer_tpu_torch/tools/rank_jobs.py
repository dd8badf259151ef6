"""Jobs on every rank of a process group of processes on one host, and the
spawner that starts them: the CPU tests of the sharding
(tests/test_torch_parallel.py, tests/test_torch_multihost.py) and
chip_smoke.py's two ranks on one card run through here.

`spawn(directory, world, job, device=..., backend=..., **kwargs)` runs
`world` processes of `python -m pathtracer_tpu_torch.tools.rank_jobs`,
each a rank of a group that meets through a file in `directory` (a
FileStore: no TCP port, so groups side by side cannot collide), runs
JOBS[job](**kwargs) on every rank, and saves each rank's result (tensors
on the host) as `{job}_rank{r}.pt` in `directory`. Every collective has
the group's timeout, and every process a time limit of its own; a rank
that fails exits non-zero with its traceback on stderr. On the CPU each
rank runs one torch thread.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# a process's own time limit, and the group's for one collective (s)
SPAWN_TIMEOUT = 240
GROUP_TIMEOUT = 60


def child_env() -> dict:
    """The environment of a spawned rank: one OpenMP thread, this checkout
    on the path, no process group of the caller's."""
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": ROOT + os.pathsep + os.environ.get("PYTHONPATH", "")}
    for name in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
                 "PT_COORDINATOR", "PT_NUM_PROCESSES", "PT_PROCESS_ID"):
        env.pop(name, None)
    return env


def start(directory, world: int, job: str, device: str = "cpu", backend: str | None = None,
          group_timeout: float = GROUP_TIMEOUT, **kwargs) -> list[subprocess.Popen]:
    """Start `job` on `world` ranks on `device` ("cpu", or "cuda:N": every
    rank on that card); finish() waits for them."""
    store = os.path.join(str(directory), f"pg_{job}")  # a group's store starts afresh
    if os.path.exists(store):
        os.remove(store)
    spec = json.dumps({"device": device, "backend": backend, "timeout": group_timeout, "kwargs": kwargs})
    return [subprocess.Popen([sys.executable, "-m", "pathtracer_tpu_torch.tools.rank_jobs", job, str(directory),
                              str(world), str(rank), spec], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True, env=child_env(), cwd=ROOT)
            for rank in range(world)]


def finish(procs: list, timeout: float = SPAWN_TIMEOUT) -> list[tuple[int, str, str]]:
    """Each process's (exit code, stdout, stderr); one that outlives
    `timeout` is killed (exit code -9), and so are the others."""
    out = []
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            try:
                stdout, stderr = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()
                stdout, stderr = p.communicate()
            out.append((p.returncode, stdout, stderr))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return out


def spawn(directory, world: int, job: str, timeout: float = SPAWN_TIMEOUT, **kwargs) -> list[tuple[int, str, str]]:
    """Run `job` on `world` ranks: start() and finish()."""
    return finish(start(directory, world, job, **kwargs), timeout)


def result(directory, job: str, rank: int) -> dict:
    return torch.load(os.path.join(str(directory), f"{job}_rank{rank}.pt"))


def _host(tree):
    """Tensors of a result on the host."""
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host(v) for v in tree)
    return tree.detach().cpu() if torch.is_tensor(tree) else tree


def _device():
    from ..parallel.launch import rank_device

    return rank_device()


def job_render(width: int, height: int, tiles: int, n_spp: int, spp: int, depth: int, dtype: str = "float32") -> dict:
    """The sharded frames of the analytical scene from key 3: the eager
    tier's and the megakernel path's (its plain version on the CPU)."""
    from ..models.analytical import make_scene
    from ..ops import rng
    from ..parallel import mesh as M

    mesh = M.make_mesh(tiles, n_spp)
    scene, key = make_scene(recursion_depth=depth, dtype=getattr(torch, dtype), device=_device()), rng.prng_key(3)
    return {"eager": M.render_frame_sharded(scene, key, mesh, width, height, spp),
            "megakernel": M.render_frame_sharded_megakernel(scene, key, mesh, width, height, spp),
            "pixels": mesh.tile_pixels(width * height), "flat_pixels": mesh.flat_pixels(width * height)}


def trainer(mesh, kernel: str, width: int, height: int, spp: int, depth: int, device=None):
    """The sharded training step of recover_demo's analytical start (its
    rgb, roughness and emission; lr 5e-2) and the true scene's frame from
    key 8, its target: (step, train, opt, target, names)."""
    from ..integrator import inverse
    from ..ops import rng
    from ..ops.megakernel import render_frame_megakernel
    from ..parallel import mesh as M

    true_scene, start_scene = inverse.demo_scenes(depth, device)
    with torch.no_grad():
        target = render_frame_megakernel(true_scene, rng.prng_key(8), width, height)[..., :3].reshape(-1, 3)
    step, (train, opt), names = M.make_train_step_sharded(mesh, inverse.DEMO_SELECTS["analytical"], start_scene,
                                                          width, height, spp, lr=5e-2, kernel=kernel)
    return step, train, opt, target, names


def train_steps(mesh, kernel: str, width: int, height: int, spp: int, depth: int = 3, steps: int = 3,
                device=None) -> dict:
    """`steps` steps of trainer()'s, step i from fold_in(key 1, i): each
    step's loss and the leaves after the last."""
    from ..ops import rng

    step, train, opt, target, names = trainer(mesh, kernel, width, height, spp, depth, device)
    losses = []
    for i in range(steps):
        train, opt, loss = step(train, opt, target, rng.fold_in(rng.prng_key(1), i))
        losses.append(float(loss))
    return {"losses": losses, "leaves": [t.detach().clone() for t in train], "names": names}


def job_train(width: int, height: int, tiles: int, n_spp: int, kernel: str, spp: int, depth: int = 3,
              steps: int = 3) -> dict:
    from ..parallel import mesh as M

    return train_steps(M.make_mesh(tiles, n_spp), kernel, width, height, spp, depth, steps, _device())


def job_run_demo() -> dict:
    """run_demo at its defaults (64x32, 4 steps)."""
    from ..parallel import launch

    return {"loss": launch.run_demo()}


def job_recover(width: int, height: int, kernel: str, steps: int = 3) -> dict:
    """recover_demo over a mesh of every rank from key 0."""
    from ..integrator import inverse
    from ..parallel.launch import global_mesh

    report = inverse.recover_demo(width=width, height=height, steps=steps, kernel=kernel,
                                  mesh=global_mesh(), device=_device(), verbose=False)
    return {"losses": report.losses, "recovered": [r.recovered for r in report.rows]}


def job_drill(steps: int, ckpt_dir: str, die_after=None) -> dict:
    """run_demo_ckpt at 32x16, its drill: rank 0 dies after `die_after`."""
    from ..parallel import launch

    return {"loss": launch.run_demo_ckpt(width=32, height=16, steps=steps, ckpt_dir=ckpt_dir, die_after=die_after)}


def _barrier_ms(fn, reps: int) -> float:
    """Host milliseconds a call of fn() takes on every rank at once: the
    ranks start together (a barrier) and each waits for its card."""
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def job_card_frame(width: int, height: int, depth: int, reps: int = 10) -> dict:
    """The analytical demo's sharded frame from key 5 through K1 on every
    rank of a 1-D mesh (render_frame_sharded_megakernel) and its launches;
    then each rank's K1 launch over its range timed alone (the other ranks
    wait at a barrier; CUDA events), the all-reduce of the [H, W, 4] frame
    and the sharded frame timed on all ranks at once (host clock to the
    card's end)."""
    from ..integrator.tracer import VERBATIM
    from ..models.analytical import make_scene
    from ..ops import megakernel as mk
    from ..ops import rng
    from ..parallel import mesh as M
    from ..utils.timing import cuda_ms

    rank, world = M.world()
    mesh = M.make_mesh(world, 1)
    scene, key = make_scene(recursion_depth=depth, device=_device()), rng.prng_key(5)
    mk.render_frame_megakernel.launches = 0
    frame = M.render_frame_sharded_megakernel(scene, key, mesh, width, height)
    torch.cuda.synchronize()
    launches = mk.render_frame_megakernel.launches
    pixels = mesh.flat_pixels(width * height)
    k = mk.prepare_launch(scene, key, width, height, 1, VERBATIM, pixels)
    launch_ms = []
    for r in range(world):
        dist.barrier()
        launch_ms.append(cuda_ms(lambda: mk.launch(k), reps) if r == rank else None)
    buf = frame.clone()
    reduce_ms = _barrier_ms(lambda: M.all_reduce(buf, mesh.world_group), reps)
    frame_ms = _barrier_ms(lambda: M.render_frame_sharded_megakernel(scene, key, mesh, width, height), reps)
    return {"frame": frame, "launches": launches, "pixels": pixels, "launch_ms": launch_ms[rank],
            "all_reduce_ms": reduce_ms, "frame_ms": frame_ms}


def job_card_step(width: int, height: int, small: tuple, small_steps: int = 3, reps: int = 3) -> dict:
    """The sharded training step through K1 and K2 (kernel="megakernel") at
    width x height, depth 4: train_steps' first step (its loss, leaves and
    this rank's K1 and K2 launches), then `small_steps` steps at `small`
    (W, H); then the big step timed on all ranks at once (host clock to
    the card's end, after a warm-up)."""
    from ..ops import megakernel as mk
    from ..ops import rng
    from ..parallel import mesh as M

    _, world = M.world()
    mesh = M.make_mesh(world, 1)
    step, train, opt, target, names = trainer(mesh, "megakernel", width, height, 1, 4, _device())
    counter = mk.render_frame_megakernel
    counter.launches = counter.bwd_launches = 0
    train, opt, loss = step(train, opt, target, rng.fold_in(rng.prng_key(1), 0))
    torch.cuda.synchronize()
    launches = (counter.launches, counter.bwd_launches)
    big = {"losses": [float(loss)], "leaves": [t.detach().clone() for t in train], "names": names}
    small_run = train_steps(mesh, "megakernel", *small, 1, depth=4, steps=small_steps, device=_device())
    key = rng.prng_key(7)
    step(train, opt, target, key)
    step_ms = _barrier_ms(lambda: step(train, opt, target, key), reps)
    return {"big": big, "launches": launches, "small": small_run, "step_ms": step_ms}


def job_nccl_probe() -> dict:
    """One all-reduce of a scalar over the group (started with NCCL)."""
    t = torch.ones(1, device=_device())
    dist.all_reduce(t)
    torch.cuda.synchronize()
    return {"sum": float(t)}


def job_parts(parts: dict) -> dict:
    """Several jobs in turn on one process group: {name: [job, kwargs]} ->
    {name: its result}."""
    return {name: JOBS[job](**kwargs) for name, (job, kwargs) in parts.items()}


JOBS = {"render": job_render, "train": job_train, "run_demo": job_run_demo, "recover": job_recover,
        "drill": job_drill, "card_frame": job_card_frame, "card_step": job_card_step, "nccl_probe": job_nccl_probe,
        "parts": job_parts}


def main(argv) -> int:
    job, directory, world, rank, spec = argv[0], argv[1], int(argv[2]), int(argv[3]), json.loads(argv[4])
    from ..parallel import launch

    if spec["device"] == "cpu":
        torch.set_num_threads(1)
    launch.initialize(init_method=f"file://{os.path.join(directory, f'pg_{job}')}", world_size=world, rank=rank,
                      backend=spec["backend"], device=spec["device"], timeout=spec["timeout"])
    out = _host(JOBS[job](**spec["kwargs"]))
    torch.save(out, os.path.join(directory, f"{job}_rank{rank}.pt"))
    if dist.is_initialized():
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
