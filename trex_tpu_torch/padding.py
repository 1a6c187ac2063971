"""Static-shape padding and bucketing utilities (counterpart of
``trex_tpu/padding.py``).

The buckets bound how many distinct shapes a sweep over problem sizes
produces (one CUDA graph or one launch plan per shape): open-ended powers
of two, with a 128-site floor for alignments beyond the smallest sizes.
Padded sites and nodes are excluded from results with boolean masks; the
DP gives padded sites zero cost by construction (all-state cost 0 at
padded leaf columns).
"""

from __future__ import annotations

import torch

SITE_BUCKETS: tuple[int, ...] = (32, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384)
K_BUCKETS: tuple[int, ...] = (2, 4, 8)
NODE_BUCKETS: tuple[int, ...] = (
    15, 31, 63, 127, 255, 511, 1023, 2047, 4095, 8191, 16383, 32767, 65535,
)


def next_bucket(value: int, buckets: tuple[int, ...] = SITE_BUCKETS) -> int:
    """Smallest bucket >= value; past the ladder, the next power of two
    times its last rung."""
    for b in buckets:
        if value <= b:
            return b
    b = buckets[-1]
    while b < value:
        b *= 2
    return b


def site_bucket(n_sites: int) -> int:
    return next_bucket(n_sites, SITE_BUCKETS)


def node_bucket(n_nodes: int) -> int:
    return next_bucket(n_nodes, NODE_BUCKETS)


def k_bucket(k: int) -> int:
    return next_bucket(k, K_BUCKETS)


def pad_axis(x: torch.Tensor, axis: int, target: int, fill=0) -> torch.Tensor:
    """Pad one axis of ``x`` up to ``target`` with ``fill`` (no-op if already)."""
    cur = x.shape[axis]
    if cur == target:
        return x
    if cur > target:
        raise ValueError(f"axis {axis} size {cur} exceeds target {target}")
    shape = list(x.shape)
    shape[axis] = target - cur
    return torch.cat([x, x.new_full(shape, fill)], dim=axis)


def pad_sites(sequences: torch.Tensor, target_sites: int) -> torch.Tensor:
    """Pad the trailing site axis of (..., L) integer sequences with state 0."""
    return pad_axis(sequences, -1, target_sites, fill=0)


def site_mask(n_real: int, n_padded: int, device="cpu") -> torch.Tensor:
    """(n_padded,) bool mask, True at real site positions."""
    return torch.arange(n_padded, device=device) < n_real


def node_mask(n_real: int, n_padded: int, device="cpu") -> torch.Tensor:
    """(n_padded,) bool mask, True at real node positions."""
    return torch.arange(n_padded, device=device) < n_real


def pad_adjacency(adjacency: torch.Tensor, target_nodes: int) -> torch.Tensor:
    """Pad a dense (N, N) adjacency to (target, target) with zeros."""
    return pad_axis(pad_axis(adjacency, -1, target_nodes), -2, target_nodes)


def pad_nk_tables(
    fitness_tables: torch.Tensor,
    interactions: torch.Tensor,
    target_sites: int,
    target_k: int,
    n_states: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Pad NK landscape tensors to bucketed (L, q^(K+1)) / (L, K) shapes.
    Padded interaction slots point at site 0 (neutral); padded table
    entries are 0."""
    tables = pad_axis(fitness_tables, -1, n_states ** (target_k + 1), fill=0.0)
    tables = pad_axis(tables, -2, target_sites, fill=0.0)
    inter = pad_axis(interactions, -1, target_k, fill=0)
    inter = pad_axis(inter, -2, target_sites, fill=0)
    return tables, inter


def masked_sum(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Sum over positions where ``mask`` is True."""
    return (values * mask).sum()


def masked_mean(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean over positions where ``mask`` is True."""
    return (values * mask).sum() / mask.sum()
