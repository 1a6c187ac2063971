"""Differentiable (smoothed-min) Sankoff dynamic programming (counterpart of
``trex_tpu/ops/soft_dp.py``).

Every ``min`` of the exact DP (``ops/sankoff.py``) becomes the temperature-
smoothed soft minimum ``softmin_T(x) = -T * logsumexp(-x / T)``, which tends
to ``min`` as T -> 0 (error at most T*log(n)). Gradients flow through the
whole recursion, to the cost matrix, the leaf costs and the temperature.

Same (nodes, states, sites) layout as the exact DP; the ancestors are
visited in index order (children before parents), each step a tensor of
(2 children, Q, Q, L). The rows are kept in a Python list rather than
written into one table, so autograd keeps one small node a step.
"""

from __future__ import annotations

import torch

from trex_tpu_torch.ops.sankoff import leaf_dp_table
from trex_tpu_torch.topology import Topology


def softmin(x: torch.Tensor, dim: int, temperature) -> torch.Tensor:
    """``-T * logsumexp(-x / T)``; the exact min in the T -> 0 limit."""
    return -temperature * torch.logsumexp(-x / temperature, dim=dim)


def soft_sankoff_score(
    topology: Topology,
    cost_matrix: torch.Tensor,
    leaf_costs: torch.Tensor,
    temperature: float | torch.Tensor = 0.1,
    site_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Differentiable parsimony score (0-d float32 tensor).

    Args:
        topology: one tree (its children are read on the host once).
        cost_matrix: (Q, Q) costs ``[parent_state, child_state]``.
        leaf_costs: (n_leaves, Q, L) per-leaf per-state costs: for hard
            leaves ``leaf_dp_table(seqs, Q)`` (0 or ``BIG_COST`` = 1e5), for
            soft beliefs e.g. ``-log p`` clipped to ``BIG_COST``.
        temperature: the smoothing T; the result lies within
            ``T * log(Q) * (2 * n_ancestors + 1)`` per site of the exact
            score.
        site_mask: optional (L,) weights of the per-site scores.

    Returns:
        The score, differentiable in ``cost_matrix``, ``leaf_costs`` and
        ``temperature``.
    """
    rows = list(leaf_costs.to(torch.float32).unbind(0))
    for left, right in topology.children.tolist():
        child_dp = torch.stack([rows[left], rows[right]])  # (2, Q, L)
        expanded = cost_matrix[None, :, :, None] + child_dp[:, None, :, :]
        rows.append(softmin(expanded, dim=2, temperature=temperature).sum(0))
    per_site = softmin(rows[-1], dim=0, temperature=temperature)
    if site_mask is not None:
        per_site = per_site * site_mask.to(per_site.dtype)
    return per_site.sum()


def soft_sankoff_score_from_sequences(
    topology: Topology,
    cost_matrix: torch.Tensor,
    leaf_sequences: torch.Tensor,
    temperature: float | torch.Tensor = 0.1,
    site_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """``soft_sankoff_score`` of hard integer leaves."""
    return soft_sankoff_score(
        topology, cost_matrix, leaf_dp_table(leaf_sequences, cost_matrix.shape[-1]),
        temperature=temperature, site_mask=site_mask,
    )


def batched_soft_sankoff_score(
    topologies: Topology,
    cost_matrix: torch.Tensor,
    leaf_sequences: torch.Tensor,
    temperature: float | torch.Tensor = 0.1,
) -> torch.Tensor:
    """(B,) scores of a batch of trees (a leading axis of ``topologies``)
    on one alignment of hard integer leaves."""
    return torch.stack([
        soft_sankoff_score_from_sequences(
            Topology(children, parents), cost_matrix, leaf_sequences, temperature)
        for children, parents in zip(topologies.children, topologies.parents)
    ])
