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

import numpy as np
import torch

from trex_tpu_torch.ops.likelihood import (
    _f32,
    _model,
    gtr_generator,
    highest_matmul_precision,
    Levels,
    _level_pruning,
    tip_partials,
)
from trex_tpu_torch.topology import Topology


def _generator(n_states, rates, freqs, prior, device):
    """The (Q, Q) generator: JC69's normalised one when no model is given,
    else the GTR one (missing ``rates``: all exchangeabilities 1)."""
    q = n_states
    if rates is None and freqs is None:
        eye = torch.eye(q, dtype=torch.float32, device=device)
        return (torch.ones((q, q), dtype=torch.float32, device=device) - q * eye) / (q - 1.0)
    rates_ = (torch.ones((q, q), dtype=torch.float32, device=device)
              if rates is None else _f32(rates, device=device))
    return gtr_generator(rates_, prior)


def _transitions(branch_lengths, n_states, rates, freqs, device=None):
    """(n_all, Q, Q) per-node transition matrices, (Q,) root prior and the
    (Q, Q) generator."""
    lengths = _f32(branch_lengths, device=device)
    transition, prior = _model(n_states, rates, freqs, lengths.device)
    return (transition(lengths), prior,
            _generator(n_states, rates, freqs, prior, lengths.device))


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
    levels = Levels(topology.children, device)

    def nll(lengths: torch.Tensor) -> torch.Tensor:
        """(K,) negative log-likelihoods of K length vectors (K, n_all)."""
        per_site = _level_pruning(levels, transition(lengths), tips, prior)
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


@highest_matmul_precision
def marginal_ancestral_posteriors(
    topology: Topology,
    branch_lengths,
    leaf_sequences,
    n_states: int,
    rates=None,
    freqs=None,
    *,
    sequences_are_masks: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-node marginal posterior state probabilities and MAP states:
    ``posterior(v) ∝ outside(v) * inside(v)``, normalised per site.

    Returns (posteriors (n_all, Q, L), map_states (n_all, L) int32, the
    first most probable state); leaf rows are the tips' data-informed
    posteriors.
    """
    device = torch.as_tensor(leaf_sequences).device
    pmats, prior, _ = _transitions(branch_lengths, n_states, rates, freqs, device)
    inside = _inside_partials(topology, pmats, leaf_sequences, n_states, sequences_are_masks)
    outside, _ = _outside_partials(topology, pmats, inside, prior)
    joint = inside * outside
    posteriors = joint / torch.clamp(joint.sum(dim=1, keepdim=True), min=1e-30)
    return posteriors, posteriors.argmax(dim=1).to(torch.int32)


@highest_matmul_precision
def joint_ancestral_reconstruction(
    topology: Topology,
    branch_lengths,
    leaf_sequences,
    n_states: int,
    rates=None,
    freqs=None,
    *,
    sequences_are_masks: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Jointly most probable ancestral states (Pupko et al. 2000): per site
    and node v,

        M_v(s_p) = max_{s_v} [ log P_v(s_p -> s_v) + T_v(s_v) ],
        T_v = sum of the children's M (leaves: 0 at allowed states,
        -1e30 elsewhere),

    the root maximising ``log prior + T_root``; the argmax tables are
    replayed from the root down (first maximum on ties).

    Returns (states (n_all, L) int32, joint_log_prob (L,)); ambiguous
    leaves get their ML resolution.
    """
    leaves = torch.as_tensor(leaf_sequences)
    device = leaves.device
    n_leaves = topology.n_leaves
    n_all = topology.n_all
    length = leaves.shape[-1]
    q = n_states
    pmats, prior, _ = _transitions(branch_lengths, n_states, rates, freqs, device)
    logp = torch.log(torch.clamp(pmats, min=1e-30))  # (n_all, Q_parent, Q_child)
    allowed = tip_partials(leaves, q, sequences_are_masks) > 0
    tip_scores = torch.where(allowed, 0.0, -1e30)  # (n_leaves, Q, L)

    messages = torch.zeros((n_all, q, length), dtype=torch.float32, device=device)
    argmax = torch.zeros((n_all, q, length), dtype=torch.int64, device=device)
    subtree = torch.zeros((n_all, q, length), dtype=torch.float32, device=device)
    cand = logp[:n_leaves, :, :, None] + tip_scores[:, None, :, :]
    messages[:n_leaves], argmax[:n_leaves] = cand.max(dim=2)
    subtree[:n_leaves] = tip_scores
    del cand
    pairs = topology.children.cpu().tolist()
    for a, (c1, c2) in enumerate(pairs):
        node = n_leaves + a
        t_v = messages[c1] + messages[c2]
        cand = logp[node][:, :, None] + t_v[None, :, :]
        messages[node], argmax[node] = cand.max(dim=1)
        subtree[node] = t_v
    root_score = torch.log(prior)[:, None] + subtree[-1]
    joint_log_prob, root_state = root_score.max(dim=0)
    states = torch.zeros((n_all, length), dtype=torch.int64, device=device)
    states[-1] = root_state
    sites = torch.arange(length, device=device)
    for a in range(len(pairs) - 1, -1, -1):
        node_state = states[n_leaves + a]
        for child in pairs[a]:
            states[child] = argmax[child][node_state, sites]
    return states.to(torch.int32), joint_log_prob


class _BatchSchedule:
    """The level-synchronous schedule of C topologies (host numpy, built
    once a chunk): flat node ids ``tree * n_all + node`` into (C * n_all)
    tables.

    ``inside``: for each height h >= 1 (every ancestor of height h depends
    only on lower ones), the ancestors of that height in every tree and
    their children, ``(nodes (K,), children (2K,): first children, then
    second)``. ``outside``: for each depth d from the roots down, the
    children of the depth's ancestors, ``(children (2K,), siblings (2K,),
    next (K',))``, ``next`` the positions among those children of the next
    depth's ancestors, in that depth's order. The launches of a pass follow
    the tallest tree, not C.
    """

    def __init__(self, children: np.ndarray, device) -> None:
        batch, n_anc, _ = children.shape
        n_leaves = n_anc + 1
        n_all = 2 * n_leaves - 1
        rows = np.arange(batch)
        base = (rows * n_all)[:, None]
        height = np.zeros((batch, n_all), np.int64)
        for a in range(n_anc):
            height[:, n_leaves + a] = 1 + np.maximum(
                height[rows, children[:, a, 0]], height[rows, children[:, a, 1]])
        flat_children = (children + base[:, :, None]).reshape(batch * n_anc, 2)

        def as_index(values):
            return torch.as_tensor(np.ascontiguousarray(values), dtype=torch.int64).to(device)

        anc_height = height[:, n_leaves:]
        self.inside = []
        for h in range(1, int(anc_height.max()) + 1):
            tree, a = np.nonzero(anc_height == h)
            kids = flat_children[tree * n_anc + a]
            self.inside.append((as_index(base[tree, 0] + n_leaves + a),
                                as_index(np.concatenate([kids[:, 0], kids[:, 1]]))))
        self.outside = []
        level = base[:, 0] + n_all - 1  # the roots
        while level.size:
            tree, local = np.divmod(level, n_all)
            kids = flat_children[tree * n_anc + local - n_leaves]
            child = np.concatenate([kids[:, 0], kids[:, 1]])
            sibling = np.concatenate([kids[:, 1], kids[:, 0]])
            nxt = np.flatnonzero(child % n_all >= n_leaves)
            self.outside.append((as_index(child), as_index(sibling), as_index(nxt)))
            level = child[nxt]


def _batched_inside(schedule: _BatchSchedule, pmats: torch.Tensor, tips: torch.Tensor,
                    batch: int) -> torch.Tensor:
    """(C * n_all, Q, L) inside partials of C trees, per-node renormalised
    as ``_inside_partials``; ``pmats`` (C * n_all, Q, Q)."""
    n_leaves, q, length = tips.shape
    n_all = 2 * n_leaves - 1
    inside = torch.empty((batch, n_all, q, length), dtype=torch.float32, device=pmats.device)
    inside[:, :n_leaves] = tips
    flat = inside.view(batch * n_all, q, length)
    for nodes, kids in schedule.inside:
        messages = torch.matmul(pmats.index_select(0, kids), flat.index_select(0, kids))
        k = nodes.numel()
        combined = messages[:k] * messages[k:]
        flat.index_copy_(0, nodes, combined / torch.clamp(
            combined.amax(dim=1, keepdim=True), min=1e-30))
    return flat


def _batched_curvatures(schedule: _BatchSchedule, pmats: torch.Tensor, gen: torch.Tensor,
                        prior: torch.Tensor, tips: torch.Tensor, weights, batch: int):
    """(gradient, hessian diagonal), each (C * n_all,), of C trees: the
    inside pass a height at a time, then the outside pass a depth at a
    time, each child's upstream contracted with P, G P and G² P as soon as
    it is known (so no upstream table is kept). The root's entries are 0
    and -1, as ``_branch_curvatures``'s."""
    n_leaves, q, length = tips.shape
    flat = _batched_inside(schedule, pmats, tips, batch)
    dpmats = torch.matmul(gen, pmats)
    stacked = torch.cat([pmats, dpmats, torch.matmul(gen, dpmats)], dim=1)  # (N, 3Q, Q)
    n = flat.shape[0]
    grad = torch.zeros((n,), dtype=torch.float32, device=flat.device)
    hess = torch.full((n,), -1.0, dtype=torch.float32, device=flat.device)
    w = 1.0 if weights is None else weights[None, :]
    outside = prior[None, :, None].expand(batch, q, length)
    for child, sibling, nxt in schedule.outside:
        up = torch.cat([outside, outside]) * torch.matmul(
            pmats.index_select(0, sibling), flat.index_select(0, sibling))
        up = up / torch.clamp(up.amax(dim=1, keepdim=True), min=1e-30)
        mats = stacked.index_select(0, child)
        terms = (up[:, None] * torch.matmul(mats, flat.index_select(0, child)).view(
            -1, 3, q, length)).sum(dim=2)  # (2K, 3, L): u, u', u''
        u = torch.clamp(terms[:, 0], min=1e-30)
        r1 = terms[:, 1] / u
        r2 = terms[:, 2] / u
        grad.index_copy_(0, child, (w * r1).sum(dim=-1))
        hess.index_copy_(0, child, (w * (r2 - r1 * r1)).sum(dim=-1))
        if nxt.numel():
            outside = torch.matmul(mats.index_select(0, nxt)[:, :q].transpose(-1, -2),
                                   up.index_select(0, nxt))
    return grad, hess


def _chunk_size(n_trees: int, n_all: int, q: int, length: int, device) -> int:
    """Candidates a chunk of ``per_site_matrix``: its inside table and the
    widest depth's temporaries take about six (n_all, Q, L) float32 tables
    a tree, within half the memory PyTorch can still use on the card (three
    scan budgets) or 6 GB on the CPU."""
    from trex_tpu_torch.utils.chunking import scan_budget_bytes

    per_tree = 6 * 4 * n_all * q * length
    return max(1, min(n_trees, 3 * scan_budget_bytes(device) // per_tree))


@highest_matmul_precision
def newton_lengths_batched(
    children,
    leaf_sequences,
    n_states: int,
    rates=None,
    freqs=None,
    weights=None,
    *,
    n_sweeps: int = 8,
    sequences_are_masks: bool = False,
    init_length: float = 0.1,
    min_length: float = 1e-6,
    max_length: float = 10.0,
) -> torch.Tensor:
    """(C, n_all) Newton-fitted branch lengths of C topologies
    ((C, n_anc, 2) children), in one batch: ``optimize_branch_lengths_newton``'s
    damped sweeps with each sweep's inside pass one gather and one batched
    product a height and its outside pass the same a depth
    (``_BatchSchedule``); every tree's proposal and its three halvings are
    scored by one K3/K4 call (``ops.likelihood_cuda``, a P per branch and
    tree: the kernel on the card, its plain version on the CPU), and each
    tree keeps, without a host sync, the lowest of them strictly below its
    current value (ties keep the earlier). ``weights`` (P,) are the
    pattern counts the fit sums with; Q must be 4 or 20."""
    from trex_tpu_torch.ops.likelihood_cuda import batched_log_likelihood_cuda

    leaves = torch.as_tensor(leaf_sequences)
    device = leaves.device
    leaves = leaves.to(torch.int32).contiguous()
    q = n_states
    host = np.asarray(children.cpu() if torch.is_tensor(children) else children, np.int32)
    batch, n_anc, _ = host.shape
    n_all = 2 * n_anc + 1
    w = (torch.ones((leaves.shape[-1],), dtype=torch.float32, device=device)
         if weights is None else _f32(weights, device=device).contiguous())
    tips = tip_partials(leaves, q, sequences_are_masks)
    transition, prior = _model(q, rates, freqs, device)
    prior = prior.contiguous()
    gen = _generator(q, rates, freqs, prior, device)
    schedule = _BatchSchedule(host, device)
    kids = torch.as_tensor(host, device=device)
    kids4 = kids.repeat_interleave(4, dim=0)

    def nll(lengths: torch.Tensor, kids: torch.Tensor) -> torch.Tensor:
        return -batched_log_likelihood_cuda(
            kids, leaves, w, prior, transition(lengths).contiguous(),
            sequences_are_masks=sequences_are_masks)

    lengths = torch.full((batch, n_all), float(init_length), dtype=torch.float32, device=device)
    current = nll(lengths, kids)
    rows = torch.arange(batch, device=device)
    for _ in range(n_sweeps):
        grad, hess = _batched_curvatures(
            schedule, transition(lengths).reshape(batch * n_all, q, q), gen, prior, tips,
            None if weights is None else w, batch)
        grad = grad.view(batch, n_all)
        hess = hess.view(batch, n_all)
        newton = lengths - grad / torch.clamp(hess, max=-1e-8)
        fallback = lengths + torch.clamp(0.1 * grad, -0.5, 0.5)
        proposed = torch.where(hess < -1e-8, newton, fallback)
        proposed = torch.clamp(proposed, min_length, max_length)
        proposed[:, -1] = lengths[:, -1]
        candidates = [proposed]
        for _ in range(3):
            candidates.append((candidates[-1] + lengths) / 2.0)
        candidates = torch.stack(candidates, dim=1)  # (C, 4, n_all)
        values = nll(candidates.view(4 * batch, n_all), kids4).view(batch, 4)
        values = torch.nan_to_num(values, nan=float("inf"))
        best_value = values.amin(dim=1)
        best = (values == best_value[:, None]).to(torch.uint8).argmax(dim=1)
        take = best_value < current
        lengths = torch.where(take[:, None], candidates[rows, best], lengths)
        current = torch.where(take, best_value, current)
    return lengths


@highest_matmul_precision
def per_site_matrix(
    trees: Topology,
    leaf_sequences,
    n_states: int,
    rates=None,
    freqs=None,
    weights=None,
    *,
    n_sweeps: int = 8,
    sequences_are_masks: bool = False,
    chunk: int | None = None,
    timings: dict | None = None,
) -> torch.Tensor:
    """(M, P) per-site log-likelihood rows of M candidate topologies, each
    at its own Newton-fitted branch lengths: the RELL primitive of aLRT,
    UFBoot and the topology tests (the one-device form of the JAX
    package's ``parallel.sharded.sharded_per_site_matrix``).

    Chunks of C candidates are fitted at once (``newton_lengths_batched``),
    then their rows come from K4's per-site mode at the fitted lengths (on
    CPU tensors its plain version). No row depends on the chunking
    (``chunk``: candidates a chunk, default from the device's memory,
    ``_chunk_size``); ``weights`` (P,) are the pattern counts the fit sums
    with (the rows are unweighted). ``timings`` gains "chunk" and
    "chunks", and the seconds of the fits ("newton") and the rows ("rows").
    """
    import time

    from trex_tpu_torch.ops.likelihood_cuda import batched_log_likelihood_cuda

    leaves = torch.as_tensor(leaf_sequences)
    device = leaves.device
    leaves = leaves.to(torch.int32).contiguous()
    length = leaves.shape[-1]
    all_children = trees.children.cpu().numpy().astype(np.int32)
    n_trees, n_anc, _ = all_children.shape
    n_all = 2 * n_anc + 1
    w = (torch.ones((length,), dtype=torch.float32, device=device) if weights is None
         else _f32(weights, device=device).contiguous())
    transition, prior = _model(n_states, rates, freqs, device)
    if chunk is None:
        chunk = _chunk_size(n_trees, n_all, n_states, length, device)
    if timings is not None:
        timings.update(chunk=chunk, chunks=-(-n_trees // chunk), newton=0.0, rows=0.0)

    def lap(name: str, since: float) -> float:
        if timings is None:
            return since
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        now = time.perf_counter()
        timings[name] += now - since
        return now

    out = torch.empty((n_trees, length), dtype=torch.float32, device=device)
    for start in range(0, n_trees, chunk):
        clock = time.perf_counter()
        host = all_children[start : start + chunk]
        lengths = newton_lengths_batched(
            host, leaves, n_states, rates, freqs, weights, n_sweeps=n_sweeps,
            sequences_are_masks=sequences_are_masks)
        clock = lap("newton", clock)
        _, rows = batched_log_likelihood_cuda(
            torch.as_tensor(host, device=device), leaves, w, prior.contiguous(),
            transition(lengths).contiguous(), sequences_are_masks=sequences_are_masks,
            per_site=True)
        out[start : start + host.shape[0]] = rows
        lap("rows", clock)
    return out
