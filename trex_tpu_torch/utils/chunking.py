"""Memory-bounded chunking of the analytic scans and of mapped functions
(counterpart of ``trex_tpu/utils/chunking.py``)."""

from __future__ import annotations

from typing import Callable

import torch

_CPU_BUDGET = 2 << 30


def auto_prune_chunk(
    n_prune: int, per_prune_bytes: int, budget_bytes: int = _CPU_BUDGET
) -> int | None:
    """Chunk size bounding an analytic scan's peak working set.

    The SPR scan materializes ``n_prune`` pruned-variant DP tensors at
    once; above ``budget_bytes`` it runs them in chunks. Returns None when
    the full scan fits, else the largest chunk within budget (>= 1).
    """
    if n_prune * per_prune_bytes <= budget_bytes:
        return None
    return max(1, int(budget_bytes // per_prune_bytes))


def scan_budget_bytes(device) -> int:
    """Bytes one scan chunk's up/down tables may take on ``device``.

    On the card: a sixth of the memory PyTorch can still use (free device
    memory plus its cache's unused part), since a chunk's temporaries
    (contexts, join masks) take about twice its up/down tables again. On
    the CPU: 2 GB.
    """
    device = torch.device(device)
    if device.type != "cuda":
        return _CPU_BUDGET
    free, _ = torch.cuda.mem_get_info(device)
    cached = torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)
    return int((free + cached) // 6)


def chunked_map(fn: Callable, xs, batch_size: int | None = None):
    """Map ``fn`` over the leading axis of ``xs`` (a tensor, or a tuple of
    tensors with one leading length) in chunks of ``batch_size``:
    ``torch.func.vmap`` within a chunk, a loop across chunks, so peak
    memory is a chunk's; ``batch_size=None`` maps one element at a time.
    Returns ``fn``'s outputs (a tensor or a tuple of them) stacked along a
    new leading axis."""
    args = xs if isinstance(xs, tuple) else (xs,)
    n = args[0].shape[0]
    if batch_size is None:
        parts = [fn(*(a[i] for a in args)) for i in range(n)]
        join = torch.stack
    else:
        mapped = torch.func.vmap(fn)
        parts = [mapped(*(a[i : i + batch_size] for a in args)) for i in range(0, n, batch_size)]
        join = torch.cat
    if isinstance(parts[0], tuple):
        return tuple(join([p[k] for p in parts]) for k in range(len(parts[0])))
    return join(parts)
