"""Shape annotations for the engine's tensor vocabulary (counterpart of
``trex_tpu/annotations.py``).

``typing.Annotated`` aliases of ``torch.Tensor`` whose metadata names the
axes, in the JAX package's terms. Pure documentation: nothing here is
checked at run time.
"""

from __future__ import annotations

from typing import Annotated

import torch

# --- sequences ---------------------------------------------------------------
EvoSequence = Annotated[torch.Tensor, "int sites"]
"""One integer-encoded sequence."""
BatchEvoSequence = Annotated[torch.Tensor, "int batch sites"]
"""A batch of integer sequences (e.g. the leaves of one tree)."""
OneHotSequence = Annotated[torch.Tensor, "float sites states"]
SoftSequences = Annotated[torch.Tensor, "float nodes sites states"]
"""Soft (probabilistic) per-node state distributions."""

# --- trees -------------------------------------------------------------------
AdjacencyMatrix = Annotated[torch.Tensor, "float nodes nodes"]
"""Dense adjacency, A[child, parent] = 1 (API boundaries only)."""
ChildIndexPairs = Annotated[torch.Tensor, "int ancestors 2"]
"""Topology.children — the engine's internal tree form."""
ParentVector = Annotated[torch.Tensor, "int nodes"]
"""Topology.parents — root maps to itself."""
TreeLogits = Annotated[torch.Tensor, "float nodes_minus_1 ancestors"]
"""Learnable parent-assignment logits for the soft topology."""

# --- Sankoff DP (sites last) -------------------------------------------------
CostMatrix = Annotated[torch.Tensor, "float states states"]
DPTable = Annotated[torch.Tensor, "float nodes states sites"]
BacktrackTable = Annotated[torch.Tensor, "int ancestors 2 states sites"]
"""Argmin child states per (ancestor, child slot, parent state, site)."""
FitchSets = Annotated[torch.Tensor, "int nodes sites"]
"""Fitch state sets as int32 bitmasks."""

# --- scalars / masks ---------------------------------------------------------
TotalCost = Annotated[torch.Tensor, "float"]
SiteMask = Annotated[torch.Tensor, "bool sites"]
NodeMask = Annotated[torch.Tensor, "bool nodes"]
