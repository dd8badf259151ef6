"""Device time of a call on the card."""

from __future__ import annotations

import torch


def cuda_ms(fn, n: int, warmup: int = 1) -> float:
    """Mean milliseconds per call of fn() on the current CUDA device: CUDA
    events around n calls, after `warmup` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n
