"""Memory-bounded chunking of the analytic scans (counterpart of
``trex_tpu/utils/chunking.py``)."""

from __future__ import annotations

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
