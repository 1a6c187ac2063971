"""Timing helper (counterpart of ``timed`` in ``trex_tpu/utils/profiling.py``)."""

from __future__ import annotations

import time
from typing import Callable

import torch


def timed(
    fn: Callable, *args, device: torch.device, warmup: int = 1, reps: int = 10
) -> tuple[float, object]:
    """Mean seconds per call of ``fn(*args)`` after ``warmup`` calls, and
    the last result.

    On the card: two CUDA events around ``reps`` calls enqueued back to
    back, so the host's work on one call overlaps the device's on the one
    before. On the CPU: the host clock.
    """
    out = None
    for _ in range(warmup):
        out = fn(*args)
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn(*args)
        return (time.perf_counter() - t0) / reps, out
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn(*args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / reps, out
