"""Exact Sankoff maximum-parsimony DP in plain PyTorch (counterpart of
``trex_tpu/ops/sankoff.py``).

- Leaf DP cost is 0 at the observed state (or every allowed state of a
  state-set bitmask) and ``BIG_COST`` (1e5) elsewhere.
- Each ancestor, in index order (children before parents), gets
  ``sum over children of min_{s'} (C[s, s'] + DP[child, s'])`` with the
  cost laid out ``C[parent_state, child_state]``.
- The score is the per-site minimum over root states, summed over sites.
- The backtracking table holds, per ancestor, child, parent state and
  site, the first child state that realises the minimum; reconstruction
  reads it root-down.

The DP layout is (nodes, states, sites), float32 throughout. The JAX
package's ``lax.scan`` over ancestors is a Python loop over ancestors,
each step vectorised over children, states, sites and (for the batched
scorers) trees. Every value is a min of sums of costs, so for integer
costs the results are exact and equal the JAX package's bit for bit.
The batched candidate scorer on the card is K5 (``ops.sankoff_cuda``).
"""

from __future__ import annotations

import torch

from trex_tpu_torch.topology import Topology, topology_from_adjacency
from trex_tpu_torch.types import BIG_COST


def leaf_dp_table(leaf_sequences: torch.Tensor, n_states: int) -> torch.Tensor:
    """(n_leaves, Q, L) f32: 0 at each leaf's observed state, ``BIG_COST``
    elsewhere (a negative, missing state is ``BIG_COST`` everywhere)."""
    states = torch.arange(n_states, dtype=torch.int32, device=leaf_sequences.device)
    observed = leaf_sequences.to(torch.int32)[:, None, :] == states[None, :, None]
    return torch.where(observed, 0.0, BIG_COST).to(torch.float32)


def leaf_dp_table_from_masks(leaf_masks: torch.Tensor, n_states: int) -> torch.Tensor:
    """(n_leaves, Q, L) f32 from int32 state-set bitmasks: 0 at every
    allowed state, ``BIG_COST`` elsewhere — the min-plus encoding of "min
    over all resolutions of the ambiguity"."""
    states = torch.arange(n_states, dtype=torch.int32, device=leaf_masks.device)
    allowed = ((leaf_masks.to(torch.int32)[:, None, :] >> states[None, :, None]) & 1) == 1
    return torch.where(allowed, 0.0, BIG_COST).to(torch.float32)


def leaf_dp(leaf_sequences: torch.Tensor, n_states: int, sequences_are_masks: bool):
    """The leaf block of the DP table from states or state-set masks."""
    if sequences_are_masks:
        return leaf_dp_table_from_masks(leaf_sequences, n_states)
    return leaf_dp_table(leaf_sequences, n_states)


def _minplus_messages(
    child_dp: torch.Tensor, cost: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Min-plus contraction of child rows ``(..., Q, L)`` with ``cost[parent,
    child]``: the messages ``(..., Q, L)`` (min over the child state for
    each parent state) and the int32 argmins, the first minimal child
    state."""
    expanded = cost[:, :, None] + child_dp[..., None, :, :]  # (..., Qp, Qc, L)
    return expanded.amin(dim=-2), torch.argmin(expanded, dim=-2).to(torch.int32)


def _minplus_min(child_dp: torch.Tensor, cost: torch.Tensor) -> torch.Tensor:
    """The messages of ``_minplus_messages`` without the argmins."""
    return (cost[:, :, None] + child_dp[..., None, :, :]).amin(dim=-2)


def _hamming_messages(child_dp: torch.Tensor) -> torch.Tensor:
    """Closed-form messages for the Hamming cost (ones - eye):
    ``min(d[s], 1 + min_{s'} d[s'])``, O(Q) per node instead of O(Q^2)."""
    return torch.minimum(child_dp, 1.0 + child_dp.amin(dim=-2, keepdim=True))


def batched_root_rows(
    children: torch.Tensor,
    leaf_table: torch.Tensor,
    cost: torch.Tensor,
    hamming: bool,
) -> torch.Tensor:
    """(B, Q, L) root DP rows of B trees.

    ``children`` (B, n_anc, 2) integer child pairs; ``leaf_table`` the
    (n_leaves, Q, L) leaf block, shared by every tree; ``cost`` (Q, Q) f32.
    The table of one call is (B, n_all, Q, L) f32, plus a (B, 2, Q, Q, L)
    temporary per step in the general mode: callers chunk B.
    """
    batch, n_anc, _ = children.shape
    n_leaves, q, length = leaf_table.shape
    device = leaf_table.device
    children = children.to(device=device, dtype=torch.int64)
    table = torch.empty((batch, n_leaves + n_anc, q, length), dtype=torch.float32, device=device)
    table[:, :n_leaves] = leaf_table
    rows = torch.arange(batch, device=device)[:, None]
    for a in range(n_anc):
        child_dp = table[rows, children[:, a]]  # (B, 2, Q, L)
        messages = _hamming_messages(child_dp) if hamming else _minplus_min(child_dp, cost)
        table[:, n_leaves + a] = messages[:, 0] + messages[:, 1]
    return table[:, -1]


def sankoff_tables(
    topology: Topology,
    cost_matrix: torch.Tensor,
    leaf_sequences: torch.Tensor,
    *,
    sequences_are_masks: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The Sankoff DP and backtracking tables of one tree.

    Returns:
        dp: (n_all, Q, L) f32 filled DP table.
        back: (n_ancestors, 2, Q, L) int32 argmin child states.
    """
    n_leaves = topology.n_leaves
    device = leaf_sequences.device
    cost = torch.as_tensor(cost_matrix, device=device).to(torch.float32)
    q = cost.shape[-1]
    length = leaf_sequences.shape[-1]
    children = topology.children.to(device=device, dtype=torch.int64)
    dp = torch.full((topology.n_all, q, length), BIG_COST, dtype=torch.float32, device=device)
    dp[:n_leaves] = leaf_dp(leaf_sequences, q, sequences_are_masks)
    back = torch.empty((topology.n_ancestors, 2, q, length), dtype=torch.int32, device=device)
    for a in range(topology.n_ancestors):
        messages, back[a] = _minplus_messages(dp[children[a]], cost)
        dp[n_leaves + a] = messages[0] + messages[1]
    return dp, back


def sankoff_score(
    topology: Topology,
    cost_matrix: torch.Tensor,
    leaf_sequences: torch.Tensor,
    site_mask: torch.Tensor | None = None,
    hamming: bool = False,
    *,
    sequences_are_masks: bool = False,
) -> torch.Tensor:
    """Exact parsimony score of one tree (0-d f32 tensor).

    Per-site minimum over root states, times ``site_mask`` when given,
    summed over sites. ``hamming=True`` takes the O(Q) closed-form messages
    (``cost_matrix`` must then be ones - eye; only its size is read).
    """
    batch = Topology(topology.children[None], topology.parents[None])
    return batched_sankoff_score(
        batch, cost_matrix, leaf_sequences, site_mask, hamming=hamming,
        sequences_are_masks=sequences_are_masks,
    )[0]


def sankoff_reconstruct(
    topology: Topology,
    cost_matrix: torch.Tensor,
    leaf_sequences: torch.Tensor,
    *,
    sequences_are_masks: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Score a tree and reconstruct its ancestral sequences.

    Returns:
        sequences: (n_all, L) int32 — leaves verbatim (with masks: the
            allowed state the downward pass picked), ancestors the first
            argmin states.
        dp: (n_all, Q, L) DP table.
        score: 0-d f32 parsimony score.

    The traceback is one reverse pass from the root: ancestors have larger
    indices than their children, so a parent's state is chosen before its
    children read it.
    """
    n_leaves = topology.n_leaves
    device = leaf_sequences.device
    length = leaf_sequences.shape[-1]
    dp, back = sankoff_tables(
        topology, cost_matrix, leaf_sequences, sequences_are_masks=sequences_are_masks
    )
    children = topology.children.to(device=device, dtype=torch.int64)
    chosen = torch.zeros((topology.n_all, length), dtype=torch.int32, device=device)
    chosen[-1] = torch.argmin(dp[-1], dim=0).to(torch.int32)
    for a in range(topology.n_ancestors - 1, -1, -1):
        parent_states = chosen[n_leaves + a].to(torch.int64)
        # back[a]: (2, Q, L) — the row of the parent's chosen state.
        picked = torch.gather(back[a], 1, parent_states.expand(2, 1, length))[:, 0]
        chosen[children[a, 0]] = picked[0]
        chosen[children[a, 1]] = picked[1]
    if not sequences_are_masks:
        chosen[:n_leaves] = leaf_sequences.to(torch.int32)
    return chosen, dp, dp[-1].amin(dim=0).sum()


def batched_sankoff_score(
    topologies: Topology,
    cost_matrix: torch.Tensor,
    leaf_sequences: torch.Tensor,
    site_mask: torch.Tensor | None = None,
    *,
    hamming: bool = False,
    sequences_are_masks: bool = False,
) -> torch.Tensor:
    """(B,) f32 scores of a batch of trees on one alignment (the trees are a
    leading axis of ``topologies``)."""
    device = leaf_sequences.device
    cost = torch.as_tensor(cost_matrix, device=device).to(torch.float32)
    leaves = leaf_dp(leaf_sequences, cost.shape[-1], sequences_are_masks)
    per_site = batched_root_rows(topologies.children, leaves, cost, hamming).amin(dim=1)
    if site_mask is not None:
        per_site = per_site * torch.as_tensor(site_mask, device=device).to(per_site.dtype)
    return per_site.sum(dim=-1)


def batched_sankoff_score_hamming(
    topologies: Topology,
    cost_matrix: torch.Tensor,
    leaf_sequences: torch.Tensor,
    site_mask: torch.Tensor | None = None,
    *,
    sequences_are_masks: bool = False,
) -> torch.Tensor:
    """``batched_sankoff_score`` with the closed-form Hamming messages."""
    return batched_sankoff_score(
        topologies, cost_matrix, leaf_sequences, site_mask, hamming=True,
        sequences_are_masks=sequences_are_masks,
    )


def run_sankoff(
    adjacency_matrix: torch.Tensor,
    cost_matrix: torch.Tensor,
    sequences: torch.Tensor,
    n_all: int,
    n_states: int,
    n_leaves: int,
    *,
    return_path: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Adjacency API with the reference's signature and outputs:
    ``(reconstructed (n_all, L) int32, dp (L, n_all, Q), total_cost)`` — the
    DP transposed to the reference's (sites, nodes, states) layout.
    Without ``return_path`` the ancestors of ``reconstructed`` are 0."""
    del n_all, n_states  # shapes carry these; kept for API parity
    sequences = torch.as_tensor(sequences)
    topo = topology_from_adjacency(torch.as_tensor(adjacency_matrix, device=sequences.device), n_leaves)
    leaf_seqs = sequences[:n_leaves].to(torch.int32)
    if return_path:
        recon, dp, score = sankoff_reconstruct(topo, cost_matrix, leaf_seqs)
    else:
        dp, _ = sankoff_tables(topo, cost_matrix, leaf_seqs)
        score = dp[-1].amin(dim=0).sum()
        recon = torch.zeros((topo.n_all, leaf_seqs.shape[-1]), dtype=torch.int32, device=leaf_seqs.device)
        recon[:n_leaves] = leaf_seqs
    return recon, dp.permute(2, 0, 1), score
