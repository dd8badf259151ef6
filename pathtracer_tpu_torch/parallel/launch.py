"""Multi-process entry point: the process group, the mesh over every rank,
and the sharded demo jobs.

Port of `pathtracer_tpu/parallel/launch.py`, over torch.distributed:

- `initialize()` makes this process a rank of the process group, from
  explicit arguments or the environment: the JAX package's PT_COORDINATOR
  (host:port of rank 0), PT_NUM_PROCESSES and PT_PROCESS_ID first, then
  torchrun's MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK and LOCAL_RANK.
  Each rank's device is `cuda:{LOCAL_RANK % device_count}`, or the CPU when
  the caller asks for it; a rank asked for the card and given none raises.
  The collectives' backend follows the layout: NCCL where each rank of a
  host owns a card of its own, gloo where ranks share a card or run on the
  CPU (gloo reduces CUDA tensors through host copies); an explicit
  `backend` overrides it. The group's `timeout` bounds every collective, so
  a survivor of a dead peer fails instead of waiting.
- `global_mesh()` is the ("tiles", "spp") mesh over every rank.
- `run_demo` is the multi-process acceptance job (a sharded inverse render
  of the analytical demo's light emission), `run_demo_ckpt` the same with
  checkpoints and a failure hook: the kill-and-restart drill.
- `python -m pathtracer_tpu_torch.parallel.launch` runs run_demo on every
  rank and prints the losses on rank 0, e.g. on one host
  `python -m torch.distributed.run --standalone --nproc-per-node 2 -m
  pathtracer_tpu_torch.parallel.launch --cpu`.

Every rank runs the same program; checkpoints are rank 0's alone.
"""

from __future__ import annotations

import argparse
import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from ..integrator.inverse import _invert_state, replace_leaves, set_adam_state
from ..models.analytical import make_scene
from ..ops import rng
from ..ops.megakernel import render_frame_megakernel
from ..utils.checkpoint import STRUCTURE_KEY, latest_checkpoint, load_checkpoint, save_checkpoint
from ..utils.sceneio import invert_state_from_jax
from .mesh import make_mesh, make_train_step_sharded, world

# the device initialize() gave this rank
_DEVICE = None
BACKENDS = ("nccl", "gloo")


def _print(line: str) -> None:
    print(line, flush=True)


def choose_backend(device: torch.device, local_ranks: int) -> tuple[str, str]:
    """(backend, why) for ranks on `device`, `local_ranks` of them on this
    host: NCCL where each owns a card of its own, else gloo."""
    if device.type != "cuda":
        return "gloo", "the ranks run on the CPU"
    cards = torch.cuda.device_count()
    if local_ranks <= cards:
        return "nccl", f"each of the {local_ranks} ranks of this host owns a card ({cards} cards)"
    return "gloo", f"{local_ranks} ranks share this host's {cards} card(s)"


def initialize(
    init_method: str | None = None,
    world_size: int | None = None,
    rank: int | None = None,
    backend: str | None = None,
    device: str | None = None,
    timeout: float = 300.0,
    log=_print,
) -> torch.device:
    """Make this process a rank of the process group and return its device
    (idempotent; a world of one rank makes no group).

    `init_method` falls back to tcp://PT_COORDINATOR, then to env://
    (torchrun's MASTER_ADDR and MASTER_PORT); `world_size` and `rank` to
    PT_NUM_PROCESSES and PT_PROCESS_ID, then WORLD_SIZE and RANK, then 1
    and 0. `device` "cpu" runs the rank on the CPU; "cuda" (or None) on
    cuda:{LOCAL_RANK % device_count}, "cuda:N" on card N; a card that is
    not there raises. `backend` (nccl or gloo) overrides choose_backend's.
    `timeout` (seconds) bounds every collective. Prints the choice."""
    global _DEVICE
    env = os.environ
    if init_method is None:
        init_method = f"tcp://{env['PT_COORDINATOR']}" if "PT_COORDINATOR" in env else "env://"
    if world_size is None:
        world_size = int(env.get("PT_NUM_PROCESSES", env.get("WORLD_SIZE", 1)))
    if rank is None:
        rank = int(env.get("PT_PROCESS_ID", env.get("RANK", 0)))
    local_ranks = int(env.get("LOCAL_WORLD_SIZE", world_size))
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if device.index is None:
            device = _local_card(rank)
        elif not torch.cuda.is_available():
            raise RuntimeError(f"rank {rank}: device {device} asked for, CUDA is not available")
        torch.cuda.set_device(device)
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}")
    chosen, why = choose_backend(device, local_ranks)
    if backend is not None:
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
        chosen, why = backend, "asked for"
    if world_size > 1 and not dist.is_initialized():
        dist.init_process_group(chosen, init_method=init_method, world_size=world_size, rank=rank,
                                timeout=datetime.timedelta(seconds=timeout))
    log(f"rank {rank}/{world_size} on {device}: backend {chosen if world_size > 1 else 'none (one rank)'} ({why})")
    _DEVICE = device
    return device


def _local_card(rank: int) -> torch.device:
    """cuda:{LOCAL_RANK % device_count} (LOCAL_RANK defaults to `rank`);
    raises where CUDA is not available."""
    if not torch.cuda.is_available():
        raise RuntimeError(f"rank {rank}: a card asked for, CUDA is not available (device='cpu' runs on the CPU)")
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)) % torch.cuda.device_count())


def rank_device() -> torch.device:
    """This rank's device: initialize()'s, else its card (`_local_card`),
    which raises where there is none: a rank runs on the CPU only where
    the caller asks for it."""
    return _DEVICE if _DEVICE is not None else _local_card(world()[0])


def global_mesh(n_tiles: int | None = None, n_spp: int = 1):
    """The ("tiles", "spp") mesh over every rank: by default all of them on
    the tiles axis."""
    _, size = world()
    return make_mesh(size // n_spp if n_tiles is None else n_tiles, n_spp)


def _demo(width: int, height: int, spp: int, lr: float, kernel: str, device):
    """run_demo's job: the mesh, the target (the demo scene at depth 2 from
    key 9) as [W H, 3], and the training step of the light's emission from
    half of it."""
    device = rank_device() if device is None else torch.device(device)
    mesh = global_mesh(n_spp=1)
    scene = make_scene(recursion_depth=2, device=device)
    with torch.no_grad():
        target = render_frame_megakernel(scene, rng.prng_key(9), width, height)[..., :3].reshape(-1, 3)
    emission = scene.lights.unpack().emission
    start = replace_leaves(scene, {f"lights.emission.{c}": getattr(emission, c) * 0.5 for c in "xyz"})
    step, state, _ = make_train_step_sharded(mesh, ("lights.emission",), start, width, height, spp, lr, kernel=kernel)
    return mesh, target, step, state


def run_demo(
    width: int = 64, height: int = 32, steps: int = 4, spp: int = 1, lr: float = 5e-2, kernel: str = "megakernel",
    device=None, log=_print,
) -> float:
    """The multi-process acceptance job: the sharded inverse render of the
    demo scene's light emission over every rank (kernel="megakernel": K1
    and K2 over each rank's range on the card, their plain versions on the
    CPU). Per-step keys as the JAX job's (key, sub = split(key) from key
    1). Returns the final loss, the same on every rank. Every rank calls it
    with the same arguments."""
    mesh, target, step, (train, opt) = _demo(width, height, spp, lr, kernel, device)
    key = rng.prng_key(1)
    loss = None
    for i in range(steps):
        key, sub = rng.split(key)
        train, opt, loss = step(train, opt, target, sub)
        if mesh.rank == 0:
            log(f"[rank 0] step {i}  loss {float(loss):.6e}")
    return float(loss)


def _load_mh(path: str, train, opt) -> tuple[int, float | None]:
    """Load an mh_ checkpoint, the port's (with the step's loss) or one the
    JAX package's run_demo_ckpt wrote (without it), into `train` and
    `opt`; returns (the step it was taken after, its loss or None)."""
    with np.load(path) as data:
        own = STRUCTURE_KEY in data.files
    if own:
        like = (*_invert_state(train, opt, 0), torch.zeros((), dtype=torch.float64))
        vals, (count, mu, nu), step, loss = load_checkpoint(path, like)
        count, step, loss = int(count), int(step), float(loss)
    else:
        vals, (count, mu, nu), step = invert_state_from_jax(path, train)
        loss = None
    with torch.no_grad():
        for t, v in zip(train, vals):
            t.copy_(v)
    set_adam_state(opt, train, (count, mu, nu))
    return step, loss


def run_demo_ckpt(
    width: int = 32, height: int = 16, steps: int = 5, spp: int = 1, lr: float = 5e-2,
    ckpt_dir: str | None = None, die_after: int | None = None, kernel: str = "megakernel", device=None,
    log=_print,
) -> float:
    """run_demo with checkpoints and a failure hook: the kill-and-restart
    drill. Step i's key is fold_in(key 1, i), so a run resumed after step k
    takes the uninterrupted run's steps k..steps bit for bit. After each
    step rank 0 alone writes `mh_{i + 1:04d}.npz` to `ckpt_dir` atomically:
    (trainable leaves, the Adam state in optax's layout, the step, its
    loss); every rank starts from the newest mh_ checkpoint there, the
    port's or one the JAX package's run_demo_ckpt wrote. `die_after=k`:
    rank 0 exits abruptly (os._exit(17)) after step k, and the other ranks'
    next collective fails within the group's timeout; recovery is a restart
    of the whole job.

    A restart after the last step returns the checkpoint's loss and takes no
    step (the JAX job steps the final state once more and overwrites its
    last checkpoint; a JAX checkpoint of the last step, which holds no loss,
    raises here)."""
    mesh, target, step, (train, opt) = _demo(width, height, spp, lr, kernel, device)
    s0, loss = 0, None
    if ckpt_dir:
        path = latest_checkpoint(ckpt_dir, prefix="mh_")
        if path is not None:
            s0, loss = _load_mh(path, train, opt)
            if mesh.rank == 0:
                log(f"[rank 0] resumed from {path} at step {s0}")
            if s0 >= steps:
                if loss is None:
                    raise ValueError(f"{path} is the run's last step and holds no loss (a JAX checkpoint)")
                return loss
    base = rng.prng_key(1)
    for i in range(s0, steps):
        train, opt, value = step(train, opt, target, rng.fold_in(base, i))
        loss = float(value)
        if mesh.rank == 0:
            if ckpt_dir:
                os.makedirs(ckpt_dir, exist_ok=True)
                state = (*_invert_state(train, opt, i + 1), torch.tensor(loss, dtype=torch.float64))
                save_checkpoint(os.path.join(ckpt_dir, f"mh_{i + 1:04d}.npz"), state)
            log(f"[rank 0] step {i}  loss {loss:.6e}")
            if die_after is not None and i + 1 >= die_after:
                os._exit(17)  # a simulated failure: no clean-up, no goodbye
    return loss


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--init-method", default=None, help="tcp://host:port of rank 0 (default: the environment)")
    ap.add_argument("--world-size", type=int, default=None)
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--backend", choices=BACKENDS, default=None, help="override the layout's choice")
    ap.add_argument("--cpu", action="store_true", help="run the ranks on the CPU (gloo)")
    ap.add_argument("--timeout", type=float, default=300.0, help="seconds a collective may take")
    ap.add_argument("--width", type=int, default=64)
    ap.add_argument("--height", type=int, default=32)
    ap.add_argument("--steps", type=int, default=4)
    args = ap.parse_args(argv)

    initialize(args.init_method, args.world_size, args.rank, args.backend, "cpu" if args.cpu else None, args.timeout)
    loss = run_demo(width=args.width, height=args.height, steps=args.steps)
    if world()[0] == 0:
        _print(f"final loss {loss:.6e}")
    if dist.is_initialized():
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
