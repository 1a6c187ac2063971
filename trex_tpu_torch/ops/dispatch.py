"""Candidate-batch scoring dispatch (counterpart of ``trex_tpu/ops/dispatch.py``).

Hamming costs with at most 32 states go to Fitch bitsets (K1); every other
cost matrix, and Hamming with more than 32 states, goes to the min-plus
Sankoff kernel (K5) in its general mode, with integer states or state-set
masks. On the card both are hand-written CUDA kernels; on the CPU their
plain versions run.
"""

from __future__ import annotations

import torch

from trex_tpu_torch.ops.fitch import batched_fitch_score, site_weights_or_ones
from trex_tpu_torch.ops.sankoff_cuda import batched_sankoff_score_cuda, is_hamming
from trex_tpu_torch.topology import Topology


def batched_scores_fastest(
    topologies: Topology,
    cost_matrix: torch.Tensor,
    leaf_sequences: torch.Tensor,
    site_weights: torch.Tensor | None = None,
    *,
    sequences_are_masks: bool = False,
) -> torch.Tensor:
    """(B,) f32 parsimony scores of a candidate batch, on the device of
    ``leaf_sequences``.

    Hamming cost with Q <= 32: Fitch (K1). Otherwise min-plus Sankoff (K5)
    with the closed form turned off, as the JAX dispatch does. Integer
    leaves of any integer type reach the kernels as int32.
    """
    q = cost_matrix.shape[-1]
    if is_hamming(cost_matrix) and q <= 32:
        return batched_fitch_score(
            topologies, leaf_sequences, site_weights,
            sequences_are_masks=sequences_are_masks,
        )
    device = leaf_sequences.device
    return batched_sankoff_score_cuda(
        topologies.children.to(device=device, dtype=torch.int32).contiguous(),
        leaf_sequences.to(torch.int32).contiguous(),
        torch.as_tensor(cost_matrix, device=device).to(torch.float32).contiguous(),
        site_weights_or_ones(site_weights, leaf_sequences.shape[-1], device),
        hamming=False,
        sequences_are_masks=sequences_are_masks,
    )
