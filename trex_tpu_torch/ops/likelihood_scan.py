"""All-SPR scan under the likelihood criterion at fixed ranking lengths
(counterpart of ``trex_tpu/ops/likelihood_scan.py``, one rate category).

With every branch at one length t0, the likelihood of any SPR
rearrangement is a local contraction of cached partials. Inserting node w
(all three incident branches t0) on the edge above v of T∖S, with the
pruned subtree S below it:

    L_site(p, v) = Σ_m (P0ᵀ upstream_v)(m) · (P0 inside_v)(m) · (P0 U_S)(m)

where ``inside`` / ``upstream`` are T∖S's partials, computed once per prune
variant with the pass-through-row trick of ``ops.spr_scan``; per-node
rescalings are tracked in log space and added back, so the scores are
absolute log-likelihoods. Exact for the all-t0 candidate trees because the
likelihood under a reversible model does not depend on the rooting.

Plain PyTorch: the up and down passes are Python loops over ancestors,
batched over the prune variants, like the parsimony scan.
"""

from __future__ import annotations

import torch

from trex_tpu_torch.ops.likelihood import (
    _f32,
    fixed_length_model,
    highest_matmul_precision,
    tip_partials,
)
from trex_tpu_torch.ops.spr_scan import best_over_segments, mask_invalid, prune_variants
from trex_tpu_torch.topology import Topology


def _up_pass(p0, var_children, tips):
    """Inside partials (C, n_all, Q, L) and log-scales (C, n_all, L)."""
    n_var, n_anc, _ = var_children.shape
    n_leaves, q, length = tips.shape
    device = tips.device
    inside = torch.zeros((n_var, n_leaves + n_anc, q, length), dtype=torch.float32, device=device)
    inside[:, :n_leaves] = tips
    ls = torch.zeros((n_var, n_leaves + n_anc, length), dtype=torch.float32, device=device)
    rows = torch.arange(n_var, device=device)
    for a in range(n_anc):
        c1, c2 = var_children[:, a, 0], var_children[:, a, 1]
        is_pass = c1 == c2
        i1 = inside[rows, c1]
        # Pass-through rows forward the child partial verbatim: the
        # suppressed edge adds no P0 hop.
        combined = torch.where(
            is_pass[:, None, None], i1,
            torch.matmul(p0, i1) * torch.matmul(p0, inside[rows, c2]),
        )
        scale = torch.clamp(combined.amax(dim=1), min=1e-30)
        inside[:, n_leaves + a] = combined / scale[:, None, :]
        ls1 = ls[rows, c1]
        ls[:, n_leaves + a] = (
            torch.where(is_pass[:, None], ls1, ls1 + ls[rows, c2]) + torch.log(scale)
        )
    return inside, ls


def _down_pass(p0, prior, var_children, inside, ls_in):
    """Upstream partials (C, n_all, Q, L) and log-scales (C, n_all, L).

    ``upstream(v)`` lives at the parent's states and excludes v's own
    branch; the root row is the prior with log-scale 0.
    """
    n_var, n_anc, _ = var_children.shape
    n_leaves = n_anc + 1
    upstream = torch.zeros_like(inside)
    upstream[:, -1] = prior[:, None]
    ls = torch.zeros_like(ls_in)
    rows = torch.arange(n_var, device=inside.device)
    for a in range(n_anc - 1, -1, -1):
        node = n_leaves + a
        c1, c2 = var_children[:, a, 0], var_children[:, a, 1]
        is_pass = c1 == c2
        parent_up = upstream[:, node]
        # Cross the node's own branch; the root has none.
        outside = parent_up if a == n_anc - 1 else torch.matmul(p0.T, parent_up)
        raw1 = outside * torch.matmul(p0, inside[rows, c2])  # sibling of c1 is c2
        scale1 = torch.clamp(raw1.amax(dim=1), min=1e-30)
        # Pass-through rows forward upstream(node) verbatim.
        up1 = torch.where(is_pass[:, None, None], parent_up, raw1 / scale1[:, None, :])
        ls1 = torch.where(
            is_pass[:, None], ls[:, node],
            ls[:, node] + ls_in[rows, c2] + torch.log(scale1),
        )
        raw2 = outside * torch.matmul(p0, inside[rows, c1])
        scale2 = torch.clamp(raw2.amax(dim=1), min=1e-30)
        ls2 = ls[:, node] + ls_in[rows, c1] + torch.log(scale2)
        upstream[rows, c1] = up1
        ls[rows, c1] = ls1
        upstream[rows, c2] = torch.where(is_pass[:, None, None], up1, raw2 / scale2[:, None, :])
        ls[rows, c2] = torch.where(is_pass[:, None], ls1, ls2)
    return upstream, ls


def _chunk_scores(p0, prior, prune_nodes, var_children, tips, weights):
    """(C, n_all) negative log-likelihoods of one chunk of prune variants."""
    inside, ls_in = _up_pass(p0, var_children, tips)
    upstream, ls_up = _down_pass(p0, prior, var_children, inside, ls_in)
    rows = torch.arange(prune_nodes.shape[0], device=tips.device)
    msg_s = torch.matmul(p0, inside[rows, prune_nodes])  # (C, Q, L)
    ls_s = ls_in[rows, prune_nodes]  # (C, L)
    joint = torch.matmul(p0, inside)
    del inside
    joint *= torch.matmul(p0.T, upstream)
    del upstream
    site_lik = (joint * msg_s[:, None]).sum(dim=2)  # (C, n_all, L)
    del joint
    per_site = (
        torch.log(torch.clamp(site_lik, min=1e-30)) + ls_in + ls_up + ls_s[:, None, :]
    )
    return -(per_site * weights).sum(dim=-1)


@highest_matmul_precision
def likelihood_spr_scan(
    topology: Topology,
    leaf_sequences,
    n_states: int,
    ranking_branch_length: float = 0.1,
    site_weights=None,
    *,
    rates=None,
    freqs=None,
    sequences_are_masks: bool = False,
    prune_nodes=None,
    prune_chunk: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Negative log-likelihoods of all SPR rearrangements (all-t0 lengths).

    Layout as ``ops.spr_scan.spr_scan``: returns (scores, base_score), where
    ``scores[i, v]`` is the negative log-likelihood of pruning
    ``prune_nodes[i]`` and regrafting above v with every branch at
    ``ranking_branch_length``, +inf at invalid pairs (with the default
    prune set, square with an all-inf root row); ``base_score`` is the
    unmodified tree's negative log-likelihood at the same lengths.

    ``rates``/``freqs``: optional GTR exchangeabilities and stationary
    frequencies (both None: JC69). ``prune_chunk`` bounds how many prune
    variants' (n_all, Q, L) tables are held at once.
    """
    leaves = torch.as_tensor(leaf_sequences)
    device = leaves.device
    tips = tip_partials(leaves, n_states, sequences_are_masks)
    length = tips.shape[-1]
    weights = (
        torch.ones((length,), dtype=torch.float32, device=device)
        if site_weights is None else _f32(site_weights, device=device)
    )
    p0, prior = fixed_length_model(n_states, ranking_branch_length, rates, freqs, device)
    children = topology.children.to(device=device, dtype=torch.int32)
    parents = topology.parents.to(device=device, dtype=torch.int32)

    full_scan = prune_nodes is None
    prune_nodes, var_children, siblings = prune_variants(children, parents, prune_nodes)
    var_children = var_children.to(torch.int64)

    base_inside, base_ls = _up_pass(p0, children.to(torch.int64)[None], tips)
    base_site = (
        torch.log(torch.clamp((prior[:, None] * base_inside[0, -1]).sum(dim=0), min=1e-30))
        + base_ls[0, -1]
    )
    base_score = -(base_site * weights).sum()
    del base_inside, base_ls

    n_prune = prune_nodes.shape[0]
    step = n_prune if prune_chunk is None else max(1, prune_chunk)
    scores = torch.cat([
        _chunk_scores(
            p0, prior, prune_nodes[s0 : s0 + step], var_children[s0 : s0 + step],
            tips, weights,
        )
        for s0 in range(0, n_prune, step)
    ])
    return mask_invalid(scores, parents, prune_nodes, siblings, full_scan), base_score


def likelihood_spr_scan_best_segmented(
    topology: Topology,
    leaf_sequences,
    n_states: int,
    ranking_branch_length: float = 0.1,
    site_weights=None,
    *,
    rates=None,
    freqs=None,
    sequences_are_masks: bool = False,
    prune_chunk: int | None = None,
    max_cells: int | None = None,
) -> tuple[float, int, int, float, int]:
    """Best ML move via segmented scans reduced on the device: the first
    minimum of the whole (n_all, n_all) table, as ``np.argmin`` of it picks.
    Returns (best_score, prune_node, regraft_node, base_score, n_finite)."""
    return best_over_segments(
        lambda pn: likelihood_spr_scan(
            topology, leaf_sequences, n_states, ranking_branch_length,
            site_weights, rates=rates, freqs=freqs,
            sequences_are_masks=sequences_are_masks,
            prune_nodes=pn, prune_chunk=prune_chunk,
        ),
        topology.n_all, torch.as_tensor(leaf_sequences).device, max_cells,
    )
