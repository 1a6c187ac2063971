"""Differentiable and exact parsimony cost functions (counterpart of
``trex_tpu/ops/costs.py``).

The surrogate costs keep the reference's quadratic gram-expansion form:
the only O(N^2 L Q) term is one ``(N, L*Q) @ (L*Q, N)`` product, a
``torch.matmul`` in float32 (the matmul precision is left at PyTorch's
default, "highest": no TF32). No N x N x L x Q tensor is ever built.

Every function takes optional leading batch axes (restarts) on its
sequences and adjacency, so R restarts are one batched matmul of
(R, N, L*Q) x (R, L*Q, N), and returns one value per restart. Lower
precision inputs (bfloat16) reach the gram product as float32, as the JAX
package asks XLA for float32 accumulation.
"""

from __future__ import annotations

import torch


def _gram(flat_a: torch.Tensor, flat_b: torch.Tensor) -> torch.Tensor:
    """(..., N, N) float32 products of the rows of two (..., N, M) tensors."""
    return torch.matmul(flat_a.float(), flat_b.float().transpose(-1, -2))


def _expanded(
    adjacency: torch.Tensor, self_energy: torch.Tensor, gram: torch.Tensor
) -> torch.Tensor:
    """``1/2 sum_ij A_ij (e_i + e_j - 2 G_ij)``, summed per leading index."""
    weighted = (
        (adjacency * self_energy[..., :, None]).sum((-1, -2))
        + (adjacency * self_energy[..., None, :]).sum((-1, -2))
        - 2.0 * (adjacency * gram).sum((-1, -2))
    )
    return weighted / 2.0


def surrogate_cost(soft_sequences: torch.Tensor, soft_adjacency: torch.Tensor) -> torch.Tensor:
    """Quadratic surrogate parsimony cost ``1/2 sum_ij A_ij ||S_i - S_j||^2``.

    Args:
        soft_sequences: (..., N, L, Q) soft state probabilities.
        soft_adjacency: (..., N, N) soft parent-assignment matrix (rows sum
            to 1); leading axes broadcast against the sequences'.
    """
    flat = soft_sequences.flatten(-2)
    self_energy = soft_sequences.square().sum((-1, -2))
    return _expanded(soft_adjacency, self_energy, _gram(flat, flat))


def soft_parsimony_cost(
    soft_sequences: torch.Tensor,
    soft_adjacency: torch.Tensor,
    cost_matrix: torch.Tensor | None = None,
) -> torch.Tensor:
    """Substitution-weighted soft cost ``1/2 sum_ij A_ij (S_i - S_j)^T C
    (S_i - S_j)`` in the same expanded form. ``cost_matrix`` may be a (Q, Q)
    matrix, a (Q,) diagonal, or None (the surrogate on probabilities)."""
    if cost_matrix is None:
        weighted = soft_sequences
    elif cost_matrix.dim() == 1:
        weighted = soft_sequences * cost_matrix
    else:
        weighted = torch.matmul(soft_sequences.float(), cost_matrix.float()).to(
            soft_sequences.dtype
        )
    self_energy = (soft_sequences * weighted).sum((-1, -2))
    gram = _gram(soft_sequences.flatten(-2), weighted.flatten(-2))
    return _expanded(soft_adjacency, self_energy, gram)


def exact_cost(
    one_hot_sequences: torch.Tensor,
    adjacency: torch.Tensor,
    substitution_matrix: torch.Tensor,
) -> torch.Tensor:
    """Exact discrete parsimony score of (possibly soft) sequences and
    topology: each node's argmax state against its argmax parent's, summed
    over every non-root edge (the last node is the root). Piecewise
    constant; an evaluation oracle. Leading axes of the sequences and the
    adjacency are batch axes; ties go to the first index."""
    states = one_hot_sequences.argmax(-1)  # (..., N, L)
    parent_idx = adjacency.argmax(-1)  # (..., N)
    batch = torch.broadcast_shapes(states.shape[:-2], parent_idx.shape[:-1])
    states = states.expand(*batch, *states.shape[-2:])
    parent_idx = parent_idx.expand(*batch, parent_idx.shape[-1])
    parent_states = torch.gather(
        states, -2, parent_idx[..., None].expand(*parent_idx.shape, states.shape[-1])
    )
    per_site = substitution_matrix[parent_states, states]
    return per_site[..., :-1, :].sum((-1, -2))
