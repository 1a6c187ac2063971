"""Inside-outside likelihood passes and the Newton branch-length fit
(counterpart of the part of ``trex_tpu/ops/likelihood_asr.py`` the ML
search needs).

For node v with parent p and sibling s:

    upstream(v) = outside(p) * (P_s @ inside(s))     (at p's states)
    outside(v)  = P_vᵀ @ upstream(v)                 (at v's states)

with ``outside(root) = prior``. Per-site renormalisations cancel in every
ratio below, so no log-scale bookkeeping is needed. The upward pass visits
ancestors in index order, the downward pass in reverse (children always
have smaller indices than their parent). Plain PyTorch: the reference
writes these passes in lax, not Pallas.
"""

from __future__ import annotations

import torch

from trex_tpu_torch.ops.likelihood import (
    _f32,
    _model,
    gtr_generator,
    highest_matmul_precision,
    pruning_per_site,
    tip_partials,
)
from trex_tpu_torch.topology import Topology


def _transitions(branch_lengths, n_states, rates, freqs, device=None):
    """(n_all, Q, Q) per-node transition matrices, (Q,) root prior and the
    (Q, Q) generator (JC69's normalised generator when no model is given)."""
    q = n_states
    lengths = _f32(branch_lengths, device=device)
    transition, prior = _model(q, rates, freqs, lengths.device)
    if rates is None and freqs is None:
        eye = torch.eye(q, dtype=torch.float32, device=lengths.device)
        gen = (torch.ones((q, q), dtype=torch.float32, device=lengths.device) - q * eye) / (q - 1.0)
    else:
        rates_ = (
            torch.ones((q, q), dtype=torch.float32, device=lengths.device)
            if rates is None else _f32(rates, device=lengths.device)
        )
        gen = gtr_generator(rates_, prior)
    return transition(lengths), prior, gen


def _inside_partials(topology, pmats, leaf_sequences, n_states, masks):
    """Upward (inside) partials, per-node renormalised; (n_all, Q, L)."""
    tips = tip_partials(leaf_sequences, n_states, masks).to(pmats.device)
    n_leaves, q, length = tips.shape
    n_all = topology.n_all
    inside = torch.zeros((n_all, q, length), dtype=torch.float32, device=pmats.device)
    inside[:n_leaves] = tips
    for a, (c1, c2) in enumerate(topology.children.cpu().tolist()):
        combined = torch.matmul(pmats[c1], inside[c1]) * torch.matmul(pmats[c2], inside[c2])
        inside[n_leaves + a] = combined / torch.clamp(
            combined.amax(dim=0, keepdim=True), min=1e-30
        )
    return inside


def _outside_partials(topology, pmats, inside, prior):
    """Downward pass: (outside, upstream), each (n_all, Q, L).

    ``upstream(v)`` lives at the parent's states and excludes v's own
    branch; ``outside(v) = P_vᵀ upstream(v)`` lives at v's states. Both are
    per-site renormalised. The root's outside is the prior and its
    upstream row is zero.
    """
    n_all, q, length = inside.shape
    n_leaves = topology.n_leaves
    outside = torch.zeros_like(inside)
    outside[-1] = prior[:, None]
    upstream = torch.zeros_like(inside)
    pairs = topology.children.cpu().tolist()
    for a in range(len(pairs) - 1, -1, -1):
        c1, c2 = pairs[a]
        parent_outside = outside[n_leaves + a]
        for child, sibling in ((c1, c2), (c2, c1)):
            up = parent_outside * torch.matmul(pmats[sibling], inside[sibling])
            up = up / torch.clamp(up.amax(dim=0, keepdim=True), min=1e-30)
            upstream[child] = up
            outside[child] = torch.matmul(pmats[child].T, up)
    return outside, upstream


def _contract(upstream, mats, inside):
    """(n_all, L) per-site ``upstream(v)ᵀ M_v inside(v)``."""
    return (upstream * torch.matmul(mats, inside)).sum(dim=1)


def _passes(topology, branch_lengths, leaf_sequences, n_states, rates, freqs, masks):
    device = torch.as_tensor(leaf_sequences).device
    pmats, prior, gen = _transitions(branch_lengths, n_states, rates, freqs, device)
    inside = _inside_partials(topology, pmats, leaf_sequences, n_states, masks)
    _, upstream = _outside_partials(topology, pmats, inside, prior)
    return pmats, gen, inside, upstream


@highest_matmul_precision
def branch_length_gradients(
    topology: Topology,
    branch_lengths,
    leaf_sequences,
    n_states: int,
    rates=None,
    freqs=None,
    site_weights=None,
    *,
    sequences_are_masks: bool = False,
) -> torch.Tensor:
    """Analytic d logL / d branch_lengths of every branch, in two passes:

        d logL / d t_v = Σ_sites w · upstream(v)ᵀ (G P_v) inside(v)
                                     / upstream(v)ᵀ P_v inside(v)

    Returns (n_all,) gradients; the root entry is 0 (no branch above).
    """
    pmats, gen, inside, upstream = _passes(
        topology, branch_lengths, leaf_sequences, n_states, rates, freqs,
        sequences_are_masks,
    )
    ratio = _contract(upstream, torch.matmul(gen, pmats), inside) / torch.clamp(
        _contract(upstream, pmats, inside), min=1e-30
    )
    if site_weights is not None:
        ratio = ratio * _f32(site_weights, device=ratio.device)[None, :]
    grads = ratio.sum(dim=-1)
    grads[-1] = 0.0
    return grads


def _branch_curvatures(
    topology, branch_lengths, leaf_sequences, n_states,
    rates, freqs, site_weights, masks,
):
    """(gradient, hessian diagonal) of logL in every branch length.

    Per site u = upstreamᵀ P inside (proportional to the site likelihood):
        d logL/dt   = Σ w u'/u,            u'  = upstreamᵀ (G P) inside
        d² logL/dt² = Σ w (u''/u − (u'/u)²), u'' = upstreamᵀ (G² P) inside
    """
    pmats, gen, inside, upstream = _passes(
        topology, branch_lengths, leaf_sequences, n_states, rates, freqs, masks,
    )
    dpmats = torch.matmul(gen, pmats)
    d2pmats = torch.matmul(gen, dpmats)
    u = torch.clamp(_contract(upstream, pmats, inside), min=1e-30)
    r1 = _contract(upstream, dpmats, inside) / u
    r2 = _contract(upstream, d2pmats, inside) / u
    w = 1.0 if site_weights is None else _f32(site_weights, device=r1.device)[None, :]
    grad = (w * r1).sum(dim=-1)
    hess = (w * (r2 - r1 * r1)).sum(dim=-1)
    grad[-1] = 0.0
    hess[-1] = -1.0
    return grad, hess


@highest_matmul_precision
def optimize_branch_lengths_newton(
    topology: Topology,
    leaf_sequences,
    n_states: int,
    rates=None,
    freqs=None,
    site_weights=None,
    *,
    sequences_are_masks: bool = False,
    init_length: float = 0.1,
    n_sweeps: int = 12,
    min_length: float = 1e-6,
    max_length: float = 10.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """ML branch lengths by damped Newton sweeps on analytic derivatives.

    Each sweep updates every branch at once with the coordinate Newton step
    ``t - g/h``; coordinates whose curvature is not negative take a
    gradient step clipped to ±0.5 instead. Lengths are clipped to
    [min_length, max_length] and the root entry is kept. The proposal and
    its three successive halvings toward the previous lengths are scored
    together (one batched pruning pass); the lowest of them that is
    strictly below the current value replaces the lengths (ties keep the
    earlier), as the reference's sequential backtracking picks.

    Returns (branch lengths (n_all,), nll curve (n_sweeps + 1,)).
    """
    leaves = torch.as_tensor(leaf_sequences)
    device = leaves.device
    n_all = topology.n_all
    tips = tip_partials(leaves, n_states, sequences_are_masks)
    transition, prior = _model(n_states, rates, freqs, device)
    weights = (
        None if site_weights is None else _f32(site_weights, device=device)
    )
    children = topology.children.to(device)

    def nll(lengths: torch.Tensor) -> torch.Tensor:
        """(K,) negative log-likelihoods of K length vectors (K, n_all)."""
        per_site = pruning_per_site(
            children.expand(lengths.shape[0], -1, -1), transition(lengths), tips, prior,
        )
        if weights is not None:
            per_site = per_site * weights
        return -per_site.sum(dim=-1)

    lengths = torch.full((n_all,), float(init_length), dtype=torch.float32, device=device)
    current = nll(lengths[None])[0]
    curve = [current]
    for _ in range(n_sweeps):
        grad, hess = _branch_curvatures(
            topology, lengths, leaves, n_states, rates, freqs, site_weights,
            sequences_are_masks,
        )
        newton = lengths - grad / torch.clamp(hess, max=-1e-8)
        fallback = lengths + torch.clamp(0.1 * grad, -0.5, 0.5)
        proposed = torch.where(hess < -1e-8, newton, fallback)
        proposed = torch.clamp(proposed, min_length, max_length)
        proposed[-1] = lengths[-1]
        candidates = [proposed]
        for _ in range(3):
            candidates.append((candidates[-1] + lengths) / 2.0)
        candidates = torch.stack(candidates)
        values = nll(candidates)
        # The reference's sequential "strictly better" backtracking.
        best_index, best_value = -1, float(current)
        for k, value in enumerate(values.cpu().tolist()):
            if value < best_value:
                best_index, best_value = k, value
        if best_index >= 0:
            lengths, current = candidates[best_index], values[best_index]
        curve.append(current)
    return lengths, torch.stack(curve)
