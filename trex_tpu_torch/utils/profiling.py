"""Timing and profiling hooks (counterpart of ``trex_tpu/utils/profiling.py``):
wall-clock timing that synchronises with the card, and ``torch.profiler``
traces."""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable

import torch


def _synchronize(result) -> None:
    """Wait for the device work behind ``result`` (a tensor, or a tuple,
    list or dict of them) when any of it lies on a CUDA device."""
    values = result.values() if isinstance(result, dict) else (
        result if isinstance(result, (tuple, list)) else (result,))
    for value in values:
        if torch.is_tensor(value) and value.device.type == "cuda":
            torch.cuda.synchronize(value.device)
            return


class Timer:
    """Accumulating wall-clock timer; ``time(result)`` waits for the card's
    work behind ``result`` before it stops the clock."""

    def __init__(self) -> None:
        self.total = 0.0
        self.count = 0

    @contextlib.contextmanager
    def time(self, result=None):
        t0 = time.perf_counter()
        yield
        if result is not None:
            _synchronize(result)
        self.total += time.perf_counter() - t0
        self.count += 1

    @property
    def mean(self) -> float:
        return self.total / max(self.count, 1)


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


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Profile the block with ``torch.profiler`` (host and, where a card is
    present, device activity) and write a Chrome trace (view in Perfetto)
    to ``log_dir/trace.json``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
