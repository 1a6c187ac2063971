"""All-SPR scan: score every SPR rearrangement without per-candidate DP
(counterpart of ``trex_tpu/ops/spr_scan.py``).

The fast-parsimony identity: pruning the subtree S rooted at p and
regrafting it on the edge above v of the remaining tree T∖S gives

    L(new) = L(T∖S) + L(S) + δ(p, v),
    δ(p, v) = 0  iff  U_p ∩ C_v ≠ ∅  else 1   (per site, weight-summed)

where ``U_p`` is S's root Fitch set and ``C_v`` the Fitch-combined up/down
context of the edge above v in T∖S. Each pruned variant differs from the
base tree in one row — the pruned node's parent becomes a pass-through
``(s, s)`` row — so node indices never shift, and one batched up pass plus
one batched down pass over the variants scores the whole neighborhood.

Plain PyTorch: the up and down passes are Python loops over ancestors,
batched over the prune variants. Unit-cost only; ambiguity masks and
integer site weights are exact.
"""

from __future__ import annotations

import numpy as np
import torch

from trex_tpu_torch.ops.fitch import as_masks, site_weights_or_ones
from trex_tpu_torch.topology import Topology
from trex_tpu_torch.utils.chunking import scan_budget_bytes

# Bytes per (prune variant, node) cell of one segment's tables: the f32
# score, the bool ancestor walk, the bool invalid mask and the masked copy.
_BYTES_PER_CELL = 10


def _combine0(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Fitch combine with 0 = "no information" identity element."""
    inter = a & b
    merged = torch.where(inter == 0, a | b, inter)
    merged = torch.where(a == 0, b, merged)
    return torch.where(b == 0, a, merged)


def _up_pass(var_children: torch.Tensor, masks: torch.Tensor):
    """(C, n_all, L) Fitch up sets and (C, L) int32 event counts."""
    n_var, n_anc, _ = var_children.shape
    n_leaves, length = masks.shape
    sets = torch.zeros(
        (n_var, n_leaves + n_anc, length), dtype=torch.int32, device=masks.device
    )
    sets[:, :n_leaves] = masks
    events = torch.zeros((n_var, length), dtype=torch.int32, device=masks.device)
    rows = torch.arange(n_var, device=masks.device)
    for a in range(n_anc):
        s1 = sets[rows, var_children[:, a, 0]]
        s2 = sets[rows, var_children[:, a, 1]]
        inter = s1 & s2
        empty = inter == 0
        sets[:, n_leaves + a] = torch.where(empty, s1 | s2, inter)
        events += empty
    return sets, events


def _down_pass(var_children: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """(C, n_all, L) down contexts (0 = none); pass-through rows forward."""
    n_var, n_anc, _ = var_children.shape
    n_leaves = n_anc + 1
    down = torch.zeros_like(up)
    rows = torch.arange(n_var, device=up.device)
    for a in range(n_anc - 1, -1, -1):
        c1 = var_children[:, a, 0]
        c2 = var_children[:, a, 1]
        d = down[:, n_leaves + a]
        is_pass = (c1 == c2)[:, None]
        ctx1 = torch.where(is_pass, d, _combine0(d, up[rows, c2]))
        ctx2 = _combine0(d, up[rows, c1])
        down[rows, c1] = ctx1
        # Pass-through rows have c1 == c2: write the forwarded context again.
        down[rows, c2] = torch.where(is_pass, ctx1, ctx2)
    return down


def _chunk_scores(
    prune_nodes: torch.Tensor,
    var_children: torch.Tensor,
    masks: torch.Tensor,
    weights: torch.Tensor,
) -> torch.Tensor:
    """(C, n_all) candidate scores of one chunk of prune variants."""
    # Each table is freed as soon as it is consumed: the peak of this
    # function is what bounds the chunk size.
    up, events = _up_pass(var_children, masks)
    down = _down_pass(var_children, up)
    # Variant totals include the pruned subtree's internal events, so
    # total(p) = L(T∖S) + L(S): the first two terms of the identity.
    totals = (events.to(torch.float32) * weights).sum(-1)
    del events
    # U_p: the pruned subtree's root set, untouched in its own variant.
    u_p = up[torch.arange(prune_nodes.shape[0], device=up.device), prune_nodes]
    ctx = _combine0(up, down)
    del up, down
    empty_join = (u_p[:, None, :] & ctx) == 0
    del ctx
    delta = torch.where(empty_join, weights, 0.0).sum(-1)
    return totals[:, None] + delta


def _max_depth(parents: np.ndarray) -> int:
    """Longest node-to-root path (edges) of a host parent vector."""
    depth = np.zeros(parents.shape[0], dtype=np.int64)
    for node in range(parents.shape[0] - 2, -1, -1):
        depth[node] = depth[parents[node]] + 1
    return int(depth.max())


def spr_scan(
    topology: Topology,
    leaf_sequences: torch.Tensor,
    site_weights: torch.Tensor | None = None,
    *,
    sequences_are_masks: bool = False,
    prune_nodes: torch.Tensor | None = None,
    prune_chunk: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact parsimony scores of all SPR rearrangements of one tree.

    Args:
        topology: single (unbatched) tree over n_all nodes.
        leaf_sequences: (n_leaves, L) int states, or int32 state-set masks
            with ``sequences_are_masks=True``.
        site_weights: optional (L,) per-site multiplicities.
        prune_nodes: optional (P,) non-root prune nodes to evaluate
            (default: every non-root node).
        prune_chunk: evaluate prune variants this many at a time, bounding
            the peak (chunk x nodes x sites) set tensors; None = all at once.

    Returns:
        scores: (P_out, n_all) f32 — ``scores[i, v]`` is the score of
            pruning ``prune_nodes[i]`` and regrafting on the edge above v;
            +inf at invalid pairs (v inside the pruned subtree, v ==
            parent(p), v == the remaining tree's root). With the default
            prune set the output is square (n_all, n_all) with an all-inf
            root row.
        base_score: 0-d f32 — the unmodified tree's score.
    """
    masks = as_masks(leaf_sequences, sequences_are_masks)
    device = masks.device
    length = masks.shape[1]
    weights = site_weights_or_ones(site_weights, length, device)
    children = topology.children.to(device=device, dtype=torch.int32)
    parents = topology.parents.to(device=device, dtype=torch.int32)

    full_scan = prune_nodes is None
    prune_nodes, var_children, siblings = prune_variants(
        children, parents, prune_nodes
    )

    base_events = _up_pass(children[None], masks)[1][0]
    base_score = (base_events.to(torch.float32) * weights).sum()

    n_prune = prune_nodes.shape[0]
    step = n_prune if prune_chunk is None else max(1, prune_chunk)
    scores = torch.cat(
        [
            _chunk_scores(
                prune_nodes[s0 : s0 + step], var_children[s0 : s0 + step],
                masks, weights,
            )
            for s0 in range(0, n_prune, step)
        ]
    )

    return mask_invalid(scores, parents, prune_nodes, siblings, full_scan), base_score


def prune_variants(children: torch.Tensor, parents: torch.Tensor, prune_nodes=None):
    """(prune_nodes (P,) int64, var_children (P, n_anc, 2), siblings (P,)).

    Variant i is the tree with ``prune_nodes[i]`` cut away: its parent's
    row becomes the pass-through pair ``(s, s)`` of its sibling s. Default
    prune set: every non-root node.
    """
    device = children.device
    n_all = parents.shape[-1]
    n_leaves = n_all - children.shape[0]
    if prune_nodes is None:
        prune_nodes = torch.arange(n_all - 1, dtype=torch.int64, device=device)
    else:
        prune_nodes = torch.as_tensor(prune_nodes, device=device).to(torch.int64)
    q_rows = parents[prune_nodes].to(torch.int64) - n_leaves  # (P,)
    row_pair = children[q_rows]  # (P, 2)
    siblings = row_pair[:, 0] + row_pair[:, 1] - prune_nodes.to(torch.int32)
    var_children = children.unsqueeze(0).repeat(prune_nodes.shape[0], 1, 1)
    var_children[torch.arange(prune_nodes.shape[0], device=device), q_rows] = (
        siblings[:, None].expand(-1, 2)
    )
    return prune_nodes, var_children, siblings


def mask_invalid(
    scores: torch.Tensor,
    parents: torch.Tensor,
    prune_nodes: torch.Tensor,
    siblings: torch.Tensor,
    full_scan: bool,
) -> torch.Tensor:
    """``scores`` (P, n_all) with +inf at the invalid (prune, regraft)
    pairs: v inside the pruned subtree, v == parent(p), v == the remaining
    tree's root. ``full_scan`` appends the all-inf root row (square output).
    """
    device = scores.device
    n_all = parents.shape[-1]
    root = n_all - 1
    # in_S[p, v]: walk v's parent chain and check whether it meets p. The
    # chain is stationary once it reaches the root (never a prune node), so
    # max depth + 1 steps give the same table as n_all steps.
    idx = torch.arange(n_all, dtype=torch.int32, device=device)
    prune32 = prune_nodes.to(torch.int32)
    ptr = idx.clone()
    in_s = torch.zeros((prune_nodes.shape[0], n_all), dtype=torch.bool, device=device)
    for _ in range(_max_depth(parents.cpu().numpy()) + 1):
        in_s |= ptr[None, :] == prune32[:, None]
        ptr = parents[ptr.long()]
    q = parents[prune_nodes]
    rem_root = torch.where(q == root, siblings, torch.full_like(q, root))
    invalid = (
        in_s
        | (idx[None, :] == q[:, None])
        | (idx[None, :] == rem_root[:, None])
        | (idx[None, :] == root)
    )
    scores = torch.where(invalid, torch.inf, scores)
    if full_scan:
        scores = torch.cat([scores, torch.full((1, n_all), torch.inf, device=device)])
    return scores


def _segment_best(scores: torch.Tensor, valid_rows: int):
    """(min, flat argmin, finite count) of one segment's (S, n_all) block.

    Rows at index >= ``valid_rows`` are masked to +inf. ``argmin`` returns
    the first minimum, so ties resolve exactly as a full-table argmin.
    """
    rows = torch.arange(scores.shape[0], device=scores.device)
    masked = torch.where((rows < valid_rows)[:, None], scores, torch.inf)
    flat = masked.reshape(-1)
    idx = torch.argmin(flat)
    return flat[idx], idx, torch.isfinite(flat).sum()


def spr_scan_best_segmented(
    topology: Topology,
    leaf_sequences: torch.Tensor,
    site_weights: torch.Tensor | None = None,
    *,
    sequences_are_masks: bool = False,
    prune_chunk: int | None = None,
    max_cells: int | None = None,
) -> tuple[float, int, int, float, int]:
    """Best SPR move via segmented scans with device-side argmin reduction.

    The prune axis is cut into segments of at most ``max_cells / n_all``
    prune nodes (default: as many as a fraction of the device's available
    memory holds); each segment reduces on the device to (min, argmin,
    finite count), every segment is queued before any scalar is read, and
    the move picked is identical to a full-table argmin (segments in order,
    strict improvement keeps the earliest minimum). Returns
    (best_score, prune_node, regraft_node, base_score, n_finite).
    """
    return best_over_segments(
        lambda pn: spr_scan(
            topology, leaf_sequences, site_weights,
            sequences_are_masks=sequences_are_masks,
            prune_nodes=pn, prune_chunk=prune_chunk,
        ),
        topology.n_all, torch.as_tensor(leaf_sequences).device, max_cells,
    )


def best_over_segments(scan_segment, n_all: int, device, max_cells: int | None = None):
    """Best move of a scan run segment by segment: ``scan_segment(pn)``
    returns the (len(pn), n_all) scores and the base score for the prune
    nodes ``pn``. Segments hold at most ``max_cells / n_all`` prune nodes
    (default: as many as a fraction of ``device``'s available memory
    holds) and each reduces on the device; the move is the first minimum
    of the whole table. Returns (best_score, prune_node, regraft_node,
    base_score, n_finite).
    """
    n_prune = n_all - 1
    if max_cells is None:
        max_cells = scan_budget_bytes(device) // _BYTES_PER_CELL
    seg = max(1, min(n_prune, max_cells // n_all))
    pending = []
    base = None
    for s0 in range(0, n_prune, seg):
        pn = torch.arange(s0, min(s0 + seg, n_prune), dtype=torch.int64)
        sc, base = scan_segment(pn)
        pending.append((s0, _segment_best(sc, pn.shape[0])))
    best = np.inf
    best_p = best_v = 0
    n_finite = 0
    for s0, (m, idx, cnt) in pending:
        m = float(m)
        n_finite += int(cnt)
        if m < best:
            best = m
            row, best_v = divmod(int(idx), n_all)
            best_p = s0 + row
    return best, best_p, best_v, float(base), n_finite
