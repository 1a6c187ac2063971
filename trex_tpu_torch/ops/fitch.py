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


def leaf_masks(leaf_sequences: torch.Tensor) -> torch.Tensor:
    """(n_leaves, L) int states -> (n_leaves, L) int32 singleton bitmasks."""
    seqs = torch.as_tensor(leaf_sequences).to(torch.int32)
    return (torch.ones_like(seqs) << seqs).contiguous()


def as_masks(leaf_sequences: torch.Tensor, sequences_are_masks: bool) -> torch.Tensor:
    """(n_leaves, L) int32 state-set bitmasks from masks or integer states."""
    if sequences_are_masks:
        return leaf_sequences.to(torch.int32).contiguous()
    return leaf_masks(leaf_sequences)


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
    n_states: int | None = None,
) -> torch.Tensor:
    """(B,) f32 unit-cost parsimony scores of a batch of trees.

    ``site_mask`` weights each site's events; ``sequences_are_masks=True``
    reads ``leaf_sequences`` as int32 state-set bitmasks (ambiguity codes,
    gaps) rather than integer states. ``n_states``, where the caller knows
    the alphabet, spares the kernel's wrapper reading it from the masks.
    """
    masks = as_masks(leaf_sequences, sequences_are_masks)
    weights = site_weights_or_ones(site_mask, masks.shape[-1], masks.device)
    children = topologies.children.to(device=masks.device, dtype=torch.int32)
    return batched_fitch_score_cuda(children.contiguous(), masks, weights, n_states=n_states)


def fitch_score(
    topology: Topology,
    leaf_sequences: torch.Tensor,
    site_mask: torch.Tensor | None = None,
    *,
    sequences_are_masks: bool = False,
    n_states: int | None = None,
) -> torch.Tensor:
    """Unit-cost parsimony score of one tree (0-d f32 tensor)."""
    batch = Topology(topology.children[None], topology.parents[None])
    return batched_fitch_score(
        batch, leaf_sequences, site_mask, sequences_are_masks=sequences_are_masks,
        n_states=n_states,
    )[0]


def _up_pass(topology: Topology, masks: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Fitch upward sets (n_all, L) int32 and per-site event counts (L,) int32."""
    n_leaves = topology.n_leaves
    children = topology.children.to(device=masks.device, dtype=torch.int64)
    sets = torch.zeros((topology.n_all, masks.shape[-1]), dtype=torch.int32, device=masks.device)
    sets[:n_leaves] = masks
    events = torch.zeros((masks.shape[-1],), dtype=torch.int32, device=masks.device)
    for a in range(topology.n_ancestors):
        c = sets[children[a]]
        inter = c[0] & c[1]
        empty = inter == 0
        sets[n_leaves + a] = torch.where(empty, c[0] | c[1], inter)
        events += empty
    return sets, events


def fitch_state_sets(
    topology: Topology,
    leaf_sequences: torch.Tensor,
    *,
    sequences_are_masks: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-node optimal-state sets and their ambiguity.

    Returns:
        sets: (n_all, L) int32 Fitch upward state-set bitmasks.
        ambiguity: (n_all, L) int32 popcounts (1 = unambiguous).
    """
    sets, _ = _up_pass(topology, as_masks(leaf_sequences, sequences_are_masks))
    bits = torch.arange(32, dtype=torch.int64, device=sets.device)
    ambiguity = (((sets.to(torch.int64) & 0xFFFFFFFF)[..., None] >> bits) & 1).sum(-1)
    return sets, ambiguity.to(torch.int32)


def _lowest_state(mask: torch.Tensor, n_states: int) -> torch.Tensor:
    """Index of the lowest set bit of each int32 mask (0 for an empty one)."""
    lsb = mask & -mask
    states = torch.zeros_like(mask)
    for b in range(n_states):
        states = torch.where(lsb == (1 << b), b, states)
    return states


def fitch_reconstruct(
    topology: Topology,
    leaf_sequences: torch.Tensor,
    n_states: int,
    *,
    sequences_are_masks: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fitch score and one optimal ancestral labeling (top-down refinement).

    The root takes the lowest state of its set; a child keeps its parent's
    state when that state is in the child's set, else takes the lowest
    state of its own set. With ``sequences_are_masks=True`` the leaves are
    resolved by the same rule instead of passed through.

    Returns:
        sequences: (n_all, L) int32 states (unambiguous leaves verbatim).
        score: 0-d f32 unweighted event count.
    """
    n_leaves = topology.n_leaves
    sets, events = _up_pass(topology, as_masks(leaf_sequences, sequences_are_masks))
    children = topology.children.to(device=sets.device, dtype=torch.int64)
    chosen = torch.zeros_like(sets)
    chosen[-1] = _lowest_state(sets[-1], n_states)
    for a in range(topology.n_ancestors - 1, -1, -1):
        parent_state = chosen[n_leaves + a]
        parent_bit = torch.ones_like(parent_state) << parent_state
        for k in range(2):
            child_set = sets[children[a, k]]
            keep = (child_set & parent_bit) != 0
            chosen[children[a, k]] = torch.where(
                keep, parent_state, _lowest_state(child_set, n_states)
            )
    if not sequences_are_masks:
        chosen[:n_leaves] = leaf_sequences.to(torch.int32)
    return chosen, events.sum().to(torch.float32)
