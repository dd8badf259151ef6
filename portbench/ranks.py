"""A cell on several cards: one process a card, joined in the port's process
group (`pathtracer_tpu_torch/parallel/launch.initialize`, NCCL on the card,
gloo on the CPU, every collective bounded by TIMEOUT_S).

The process that `run.py` starts is rank 0. It spawns ranks 1..n-1
(`rank.py`, a process each, on cards 1..n-1) with a job before it imports
torch, so that their imports run beside its own (this module imports torch
only inside the functions that need it), and joins the group beside them.
Every rank runs with OMP_NUM_THREADS=1 unless it is set, as the workers of
`torch.distributed.run` do, and runs the same job on its own copy of the
driver; rank 0 alone owns the window's clock, the profiler, the comparison
and the result line (`harness.py`), or the readings (`calibrate.py`).

A run that loses a rank ends: from the moment it joins the group, rank 0
watches its ranks, and one that exits with another code than 0 makes rank
0 kill and reap the others and exit with DIED at once (before, a rank 0
that finds too few cards kills them and exits with 2). A rank whose rank
0 has gone exits with DIED too. A rank stuck in a collective fails it
after TIMEOUT_S (NCCL's watchdog aborts its process, gloo raises), and
the two rules end the rest. Every rank's standard output goes to rank 0's
standard error: rank 0's last line of standard output stays the result.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

TIMEOUT_S = 180.0  # every collective of the group, and the rendezvous
JOIN_S = 60.0  # for the ranks to exit once the group is torn down
DIED = 4  # the exit code of a run that lost a rank
SCRIPT = Path(__file__).resolve().with_name("rank.py")


class RankFailed(RuntimeError):
    pass


def free_port() -> int:
    """A free TCP port on this host, for the group's rendezvous."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def window_job(cell: str, seed: int, seconds: float, root, size=None, fault=None) -> tuple[int, dict]:
    """(the cell's chips, the job of its ranks' run: `harness.rank_window`),
    read from the benchmark's files alone."""
    from . import spec

    root = Path(root)
    entries = {w["name"]: w for w in spec.benchmark(root)["workloads"]}
    if cell not in entries:
        raise KeyError(f"no workload {cell!r} in BENCHMARK.json (have {sorted(entries)})")
    w = entries[cell]
    kind = spec.load_json(spec.named_file(root, "traffic", w["traffic"], ".json"))["kind"]
    return int(w["chips"]), dict(job="window", cell=cell, kind=kind, seed=seed, seconds=seconds, root=str(root),
                                 size=size, fault=fault)


def join_group(rank: int, world: int, init_method: str, device: str):
    """This process as rank `rank` of the group: NCCL on card `rank`, or
    gloo on the CPU; returns its device."""
    from pathtracer_tpu_torch.parallel import launch

    cuda = device == "cuda"
    return launch.initialize(init_method, world, rank, "nccl" if cuda else "gloo",
                             f"cuda:{rank}" if cuda else "cpu", TIMEOUT_S,
                             log=lambda line: print(f"portbench: {line}", file=sys.stderr, flush=True))


def gather(peak: int, loaded: int, device) -> tuple[int, int]:
    """Every rank, after the window: (the largest memory peak, the most
    forbidden modules) over the ranks."""
    import torch
    import torch.distributed as dist

    t = torch.tensor([float(peak), float(loaded)], dtype=torch.float64, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return int(t[0]), int(t[1])


def leave() -> None:
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


class Ranks:
    """Rank 0's side of a group of `world` ranks: ranks 1..world-1 spawned
    on construction with `job` (a JSON object that `rank.py` hands to
    `child`), watched from `join` until `close`; used as a context
    manager, whatever is still running at its end is killed and reaped."""

    def __init__(self, world: int, job: dict, device: str):
        self.world, self.device = world, device
        self.init_method = f"tcp://localhost:{free_port()}"
        # one OpenMP thread a rank unless set, as torch.distributed.run starts its workers; set here, rank 0
        # takes it too where it has not imported torch yet (run.py)
        os.environ.setdefault("OMP_NUM_THREADS", "1")
        self.procs = []
        for r in range(1, world):
            spec = dict(job, rank=r, world=world, init_method=self.init_method, device=device)
            # standard output to rank 0's standard error (fd 2)
            self.procs.append(subprocess.Popen([sys.executable, str(SCRIPT), json.dumps(spec)], stdout=2))
            print(f"portbench: rank {r} is process {self.procs[-1].pid}", file=sys.stderr, flush=True)
        self.done = threading.Event()

    def _watch(self) -> None:
        while not self.done.wait(0.2):
            for r, p in enumerate(self.procs, 1):
                code = p.poll()
                if code not in (None, 0):
                    print(f"portbench: rank {r} exited with code {code}; the run ends", file=sys.stderr, flush=True)
                    self.kill()
                    os._exit(DIED)

    def join(self):
        """Rank 0 joins the group and watches the other ranks; returns its
        device."""
        threading.Thread(target=self._watch, daemon=True).start()
        self.joined = join_group(0, self.world, self.init_method, self.device)
        return self.joined

    def close(self, peak: int, loaded: int) -> int:
        """After the window: the largest memory peak over the ranks; the
        group torn down and every rank joined. A rank that loaded a
        forbidden module or exits with another code than 0 raises
        RankFailed."""
        peak, loaded = gather(peak, loaded, self.joined)
        leave()
        codes = []
        for p in self.procs:
            try:
                codes.append(p.wait(timeout=JOIN_S))
            except subprocess.TimeoutExpired:
                codes.append(None)
        self.done.set()
        if loaded or any(c != 0 for c in codes):
            raise RankFailed(f"ranks 1..{self.world - 1} exited with {codes}; forbidden modules on a rank: {loaded}")
        return peak

    def kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            p.wait()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.done.set()
        self.kill()


def orphan_guard() -> None:
    """A rank other than 0 exits with DIED once its rank 0 has gone."""
    parent = os.getppid()

    def watch():
        while True:
            time.sleep(0.5)
            if os.getppid() != parent:
                os._exit(DIED)

    threading.Thread(target=watch, daemon=True).start()


def child(job: dict) -> int:
    """A rank other than 0: its job (`harness.rank_window`, or
    `calibrate.rank_items`), under the fault planted in rank 0 where there
    is one (`faults.planted`)."""
    import contextlib

    import torch

    from . import calibrate, faults, harness

    orphan_guard()
    if job["device"] == "cpu":
        torch.set_num_threads(1)
    jobs = {"window": harness.rank_window, "calibrate": calibrate.rank_items}
    with faults.planted(job["kind"], job["fault"]) if job.get("fault") else contextlib.nullcontext():
        return jobs[job["job"]](job)
