"""Analytic all-NNI likelihood rescoring: one up and one down pass a chain,
exact log-likelihoods of every NNI neighbour (counterpart of
``trex_tpu/ops/nni_scan.py``, which writes it in lax).

With ``M_v = P_{t_v} @ inside(v)`` the message of subtree v through its own
branch and ``O_p`` the outside partial at p's states, the neighbour that
swaps c's sibling s with c's child g (keeping k under c) has per-site
likelihood ``sum_x O_p(x) M_g(x) [P_{t_c} @ (M_s * M_k)](x)``: each subtree
keeps its structure and its length, and the edge above c keeps t_c (the
pointer-swap carry of ``ops.tree_moves``). Both passes carry per-site
log-scales, so the values are absolute log-likelihoods.

Batched over a leading chain axis, as the reference vmaps it: the passes
visit ancestor offsets in index order for every chain at once (valid for
the numbering ``ops.tree_moves`` keeps), so nothing is scheduled on the
host and no call syncs with it. The log-scales are summed after the
passes by products with the trees' ancestor matrix, where the reference
carries them node by node (sums in another order, about 1e-7 apart).
Plain PyTorch at full float32 (TF32 off).
"""

from __future__ import annotations

import torch

from trex_tpu_torch.ops.likelihood import (
    highest_matmul_precision,
    jc69_transition,
    tip_partials,
)
from trex_tpu_torch.ops.tree_moves import ancestor_matrix, parents_from_children


def _inputs(lengths, leaf_sequences, n_states, transition_matrices, root_prior,
            site_weights):
    """(P (C, n_all, Q, Q), root prior (C, Q), weights (L,))."""
    batch = lengths.shape[0]
    q = n_states
    device = lengths.device
    pmats = (jc69_transition(lengths, q) if transition_matrices is None
             else transition_matrices.to(torch.float32))
    if root_prior is None:
        root_prior = torch.full((q,), 1.0 / q, device=device)
    root_prior = root_prior.to(torch.float32).expand(batch, q)
    length = leaf_sequences.shape[-1]
    weights = (torch.ones((length,), device=device) if site_weights is None
               else site_weights.to(torch.float32))
    return pmats, root_prior, weights


def _flat_rows(children):
    """(n_anc, C, 2) rows of each ancestor's two children in a node-major
    table flattened to (n_all x C, ...): node x C + chain."""
    batch = children.shape[0]
    chains = torch.arange(batch, device=children.device)[:, None]
    return (children.long() * batch + chains[..., None]).transpose(0, 1).reshape(
        children.shape[1], -1)


def _inside(children, pk, tips, n_leaves: int):
    """Inside partials, node-major (n_all, C, Q, L), each ancestor's divided
    by its per-site maximum (floored at 1e-30), and those maxima
    (n_anc, C, L). ``pk`` (n_anc, C, 2, Q, Q): the P of each ancestor's
    two children. Six launches an ancestor: a row gather, a batched
    product, the combine, the maximum, its floor and the division, each
    writing its own rows."""
    batch, n_anc, _ = children.shape
    q, length = tips.shape[1], tips.shape[2]
    device = tips.device
    inside = torch.empty((n_leaves + n_anc, batch, q, length), device=device)
    inside[:n_leaves] = tips[:, None]
    flat = inside.view(-1, q, length)
    scales = torch.empty((n_anc, batch, length), device=device)
    rows = _flat_rows(children)
    for a in range(n_anc):
        kids = flat.index_select(0, rows[a]).view(batch, 2, q, length)
        msgs = torch.matmul(pk[a], kids)
        combined = msgs[:, 0] * msgs[:, 1]
        torch.amax(combined, dim=1, out=scales[a])
        scales[a].clamp_(min=1e-30)
        torch.div(combined, scales[a][:, None], out=inside[n_leaves + a])
    return inside, scales


def _child_pmats(children, pmats):
    """(n_anc, C, 2, Q, Q): the P of each ancestor's two children."""
    rows = torch.arange(children.shape[0], device=pmats.device)[:, None, None]
    return pmats[rows, children.long()].transpose(0, 1).contiguous()


@highest_matmul_precision
def nni_neighborhood_lnl(
    children: torch.Tensor,
    lengths: torch.Tensor,
    leaf_sequences: torch.Tensor,
    n_states: int,
    *,
    transition_matrices: torch.Tensor | None = None,
    root_prior: torch.Tensor | None = None,
    site_weights: torch.Tensor | None = None,
    sequences_are_masks: bool = False,
) -> torch.Tensor:
    """(C, K) exact log-likelihoods of the K = 2 (n - 2) NNI neighbours of
    each chain's tree; neighbour 2 e + v is ``ops.tree_moves.
    nni_neighbor_device(children, lengths, e, v, n)`` with its carried
    lengths.

    Args:
        children: (C, n_anc, 2) children in index order.
        lengths: (C, n_all) branch lengths (the root's unused).
        transition_matrices: optional (C, n_all, Q, Q) P a branch (else
            JC69 of the lengths); pair it with ``root_prior``.
        root_prior: (Q,) or (C, Q) root distribution, uniform when None.
        site_weights: optional (L,) multiplicities.

    The passes keep each ancestor's scale maxima and sum their logs over
    subtrees (inside) and paths to the root (outside) after the loops, as
    two products with the trees' ``ancestor_matrix``: six launches an
    ancestor a pass, on node-major tables.
    """
    batch, n_anc, _ = children.shape
    n_leaves = n_anc + 1
    n_all = n_leaves + n_anc
    device = lengths.device
    pmats, prior, weights = _inputs(lengths, leaf_sequences, n_states, transition_matrices,
                                    root_prior, site_weights)
    tips = tip_partials(leaf_sequences, n_states, sequences_are_masks)
    kids = children.long()
    pk = _child_pmats(children, pmats)
    inside, scales = _inside(children, pk, tips, n_leaves)
    # up[u, v] = 1: v is u or above it. A node's inside log-scale sums its
    # subtree's ancestors' scales.
    up = ancestor_matrix(children, n_leaves)
    ls_in = torch.matmul(up[:, n_leaves:].transpose(1, 2), torch.log(scales).transpose(0, 1))
    # The message of every node through its own branch (the root's unused).
    msg = torch.matmul(pmats.transpose(0, 1), inside)

    # Outside partials at each node's own states: a child's is P^T of its
    # parent's outside times its sibling's message, divided by its per-site
    # maximum.
    rows = torch.arange(batch, device=device)[:, None]
    rows3 = rows[:, :, None]
    length = inside.shape[-1]
    flat_rows = _flat_rows(children)
    sib_msg = msg.view(-1, n_states, length).index_select(
        0, _flat_rows(children.flip(-1)).view(-1)).view(n_anc, batch, 2, n_states, length)
    pk_t = pk.transpose(-1, -2).contiguous()
    outside = torch.empty_like(inside)
    outside[-1] = prior[:, :, None].expand(batch, n_states, length)
    flat_out = outside.view(-1, n_states, length)
    norms = torch.empty((n_anc, batch, 2, length), device=device)
    for a in reversed(range(n_anc)):
        upstream = outside[n_leaves + a, :, None] * sib_msg[a]
        torch.amax(upstream, dim=2, out=norms[a])
        norms[a].clamp_(min=1e-30)
        child = torch.matmul(pk_t[a], upstream.div_(norms[a][:, :, None]))
        flat_out.index_copy_(0, flat_rows[a], child.view(-1, n_states, length))
    # A child's outside log-scale adds its sibling's inside one and its
    # norm to its parent's: summed down each path from the root.
    step = torch.zeros((batch, n_all, length), device=device)
    step[rows3, kids] = torch.log(norms).transpose(0, 1) + ls_in[rows3, kids.flip(-1)]
    ls_out = torch.matmul(up, step)

    # Per-edge exact NNI rescoring.
    parents = parents_from_children(children, n_leaves)
    c_nodes = torch.arange(n_leaves, n_leaves + n_anc - 1, device=device).expand(batch, -1)
    p_nodes = parents[:, n_leaves:-1]
    p_kids = kids[rows, p_nodes - n_leaves]
    sib = torch.where(p_kids[..., 0] == c_nodes, p_kids[..., 1], p_kids[..., 0])
    a_nodes, b_nodes = kids[:, :-1, 0], kids[:, :-1, 1]
    m_a, m_b, m_s = msg[a_nodes, rows], msg[b_nodes, rows], msg[sib, rows]
    o_p = outside[p_nodes, rows]
    p_c = pmats[:, n_leaves:-1]
    ls_edge = ls_out[rows, p_nodes] + ls_in[rows, a_nodes] + ls_in[rows, b_nodes] + ls_in[rows, sib]

    def variant_lnl(m_g, m_k):
        t = torch.matmul(p_c, m_s * m_k)
        w = (o_p * m_g * t).sum(dim=2)
        per_site = torch.log(torch.clamp(w, min=1e-30)) + ls_edge
        return (per_site * weights).sum(dim=-1)

    return torch.stack([variant_lnl(m_a, m_b), variant_lnl(m_b, m_a)], dim=2).reshape(batch, -1)


@highest_matmul_precision
def tree_lnl_via_scan(
    children: torch.Tensor,
    lengths: torch.Tensor,
    leaf_sequences: torch.Tensor,
    n_states: int,
    *,
    transition_matrices: torch.Tensor | None = None,
    root_prior: torch.Tensor | None = None,
    site_weights: torch.Tensor | None = None,
    sequences_are_masks: bool = False,
) -> torch.Tensor:
    """(C,) log-likelihoods of the chains' current trees through the same
    inside pass (the identity variant of the rescoring): the oracle that
    validates the messages and scales ``nni_neighborhood_lnl`` reads."""
    n_leaves = children.shape[1] + 1
    pmats, prior, weights = _inputs(lengths, leaf_sequences, n_states, transition_matrices,
                                    root_prior, site_weights)
    tips = tip_partials(leaf_sequences, n_states, sequences_are_masks)
    inside, scales = _inside(children, _child_pmats(children, pmats), tips, n_leaves)
    ls = torch.log(scales).sum(dim=0)
    site_lik = (prior[:, :, None] * inside[-1]).sum(dim=1)
    return ((torch.log(torch.clamp(site_lik, min=1e-30)) + ls) * weights).sum(dim=-1)
