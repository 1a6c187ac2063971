"""Core constants, the parsimony cost model and the generated-data container
(counterpart of ``trex_tpu/types.py``).

Node ordering follows the engine's numerics contract: leaves
``0..n_leaves-1``, ancestors ``n_leaves..n_all-1``, root at ``n_all - 1``,
``n_all = 2 * n_leaves - 1``. Dense adjacencies (at API boundaries only)
follow ``A[child, parent] = 1``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

# Sentinel cost for impossible leaf states in the Sankoff DP.
BIG_COST = 1e5


class PhyloData(NamedTuple):
    """A generated phylogenetic dataset (``models.mutation_tree``)."""

    masked_sequences: torch.Tensor
    """(n_all, L) sequences with ancestor rows zeroed; leaves observed."""
    all_sequences: torch.Tensor
    """(n_all, L) full ground-truth sequences including ancestors."""
    adjacency: torch.Tensor
    """(n_all, n_all) dense adjacency, A[child, parent] = 1."""


@dataclasses.dataclass(frozen=True)
class CostModel:
    """Substitution cost model for parsimony scoring: a (Q, Q) cost matrix,
    ``matrix[parent_state, child_state]``."""

    matrix: torch.Tensor

    @property
    def n_states(self) -> int:
        return self.matrix.shape[-1]

    @staticmethod
    def hamming(
        n_states: int, dtype: torch.dtype = torch.float32, device="cpu"
    ) -> "CostModel":
        """Unit substitution costs: ``ones - eye``."""
        m = torch.ones((n_states, n_states), dtype=dtype, device=device)
        return CostModel(matrix=m - torch.eye(n_states, dtype=dtype, device=device))

    @staticmethod
    def transition_transversion(
        transition_cost: float = 1.0,
        transversion_cost: float = 2.0,
        dtype: torch.dtype = torch.float32,
        device="cpu",
    ) -> "CostModel":
        """DNA weighted-parsimony costs over the ACGT alphabet: transitions
        (A<->G, C<->T) cost ``transition_cost``, transversions
        ``transversion_cost``, no change 0."""
        m = torch.full((4, 4), transversion_cost, dtype=dtype, device=device)
        m.fill_diagonal_(0.0)
        for a, b in ((0, 2), (1, 3)):  # A<->G, C<->T
            m[a, b] = m[b, a] = transition_cost
        return CostModel(matrix=m)
