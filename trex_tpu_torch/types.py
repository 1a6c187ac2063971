"""Core constants and the parsimony cost model (counterpart of ``trex_tpu/types.py``).

Node ordering follows the engine's numerics contract: leaves
``0..n_leaves-1``, ancestors ``n_leaves..n_all-1``, root at ``n_all - 1``,
``n_all = 2 * n_leaves - 1``.
"""

from __future__ import annotations

import dataclasses

import torch

# Sentinel cost for impossible leaf states in the Sankoff DP.
BIG_COST = 1e5


@dataclasses.dataclass(frozen=True)
class CostModel:
    """Substitution cost model for parsimony scoring: a (Q, Q) cost matrix."""

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
