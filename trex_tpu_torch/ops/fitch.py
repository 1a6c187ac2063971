"""Fitch bitset parsimony for unit (Hamming) costs (counterpart of
``trex_tpu/ops/fitch.py``).

Each node's set of optimal states is one int32 bitmask per site: intersect
the children's sets, and count an event (and take the union) when the
intersection is empty. Per-site events are int32 and multiply the site
weights once at the end — exact for the integer weights of compressed
patterns. Scoring goes through K1 (``ops.fitch_cuda``): the CUDA kernel for
tensors on the card, its plain version for tensors on the CPU.
"""

from __future__ import annotations

import torch

from trex_tpu_torch.ops.fitch_cuda import batched_fitch_score_cuda
from trex_tpu_torch.topology import Topology


def as_masks(leaf_sequences: torch.Tensor, sequences_are_masks: bool) -> torch.Tensor:
    """(n_leaves, L) int32 state-set bitmasks from masks or integer states."""
    seqs = leaf_sequences.to(torch.int32)
    if sequences_are_masks:
        return seqs.contiguous()
    return (torch.ones_like(seqs) << seqs).contiguous()


def site_weights_or_ones(site_weights, length: int, device) -> torch.Tensor:
    """(L,) f32 site weights on ``device``; all ones when ``None``."""
    if site_weights is None:
        return torch.ones((length,), dtype=torch.float32, device=device)
    return torch.as_tensor(site_weights, device=device).to(torch.float32).contiguous()


def batched_fitch_score(
    topologies: Topology,
    leaf_sequences: torch.Tensor,
    site_mask: torch.Tensor | None = None,
    *,
    sequences_are_masks: bool = False,
) -> torch.Tensor:
    """(B,) f32 unit-cost parsimony scores of a batch of trees.

    ``site_mask`` weights each site's events; ``sequences_are_masks=True``
    reads ``leaf_sequences`` as int32 state-set bitmasks (ambiguity codes,
    gaps) rather than integer states.
    """
    masks = as_masks(leaf_sequences, sequences_are_masks)
    weights = site_weights_or_ones(site_mask, masks.shape[-1], masks.device)
    children = topologies.children.to(device=masks.device, dtype=torch.int32)
    return batched_fitch_score_cuda(children.contiguous(), masks, weights)


def fitch_score(
    topology: Topology,
    leaf_sequences: torch.Tensor,
    site_mask: torch.Tensor | None = None,
    *,
    sequences_are_masks: bool = False,
) -> torch.Tensor:
    """Unit-cost parsimony score of one tree (0-d f32 tensor)."""
    batch = Topology(topology.children[None], topology.parents[None])
    return batched_fitch_score(
        batch, leaf_sequences, site_mask, sequences_are_masks=sequences_are_masks
    )[0]
