"""Candidate-batch scoring dispatch (counterpart of ``trex_tpu/ops/dispatch.py``).

Hamming costs with at most 32 states go to Fitch bitsets (K1). Other cost
matrices need the min-plus Sankoff kernel (K5), which a later slice ports.
"""

from __future__ import annotations

import torch

from trex_tpu_torch.ops.fitch import batched_fitch_score
from trex_tpu_torch.topology import Topology


def _is_hamming(cost_matrix: torch.Tensor) -> bool:
    c = torch.as_tensor(cost_matrix).detach().cpu().to(torch.float64)
    q = c.shape[-1]
    return bool(torch.equal(c, torch.ones((q, q), dtype=torch.float64) - torch.eye(q, dtype=torch.float64)))


def batched_scores_fastest(
    topologies: Topology,
    cost_matrix: torch.Tensor,
    leaf_sequences: torch.Tensor,
    site_weights: torch.Tensor | None = None,
    *,
    sequences_are_masks: bool = False,
) -> torch.Tensor:
    """(B,) f32 parsimony scores of a candidate batch.

    Hamming costs (Q <= 32) only: Fitch bitsets, through K1 on the card.
    """
    if not (_is_hamming(cost_matrix) and cost_matrix.shape[-1] <= 32):
        raise NotImplementedError(
            "only Hamming costs with <= 32 states are ported; general cost "
            "matrices need the Sankoff kernel (K5), slice 3 of ROADMAP.md"
        )
    return batched_fitch_score(
        topologies, leaf_sequences, site_weights,
        sequences_are_masks=sequences_are_masks,
    )
