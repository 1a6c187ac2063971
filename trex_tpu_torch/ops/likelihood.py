"""Felsenstein pruning likelihood (counterpart of ``trex_tpu/ops/likelihood.py``):
the transition matrices, the pruning recursion, the +G/+I/+R rate
mixtures, the model grammar and the Adam fits of lengths and models.

Models: Jukes-Cantor (JC69) generalised to Q states, and reversible GTR
(symmetric exchangeabilities + stationary frequencies) with its named
submodels. Underflow is handled as in the reference: per node, each site's
partials are divided by their maximum (floored at 1e-30) and the log of
that scale is accumulated. The recursion runs a level of the tree at a
time (``Levels``), the categories of a rate mixture as a leading axis of
one pass, and builds no tensor in place, so autograd differentiates it.

Everything is float32. The Q x Q transition and message products run at full
float32 (``highest_matmul_precision``): TF32-grade products move the total
log-likelihood by about 1%, which is visible to model selection.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import re

import numpy as np
import torch

from trex_tpu_torch.topology import Topology


def highest_matmul_precision(fn):
    """Run ``fn`` with float32 products at full float32 precision (TF32
    off), restoring the caller's settings after."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        saved = (
            torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision(),
        )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
        try:
            return fn(*args, **kwargs)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = saved[0]
            torch.backends.cudnn.allow_tf32 = saved[1]
            torch.set_float32_matmul_precision(saved[2])

    return wrapped


def _f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, device=device).to(torch.float32)


def jc69_transition(branch_length, n_states: int) -> torch.Tensor:
    """(..., Q, Q) JC69 transition matrices for branch lengths of shape (...)."""
    q = n_states
    t = _f32(branch_length)
    decay = torch.exp(-q / (q - 1.0) * t)[..., None, None]
    same = 1.0 / q + (1.0 - 1.0 / q) * decay
    diff = 1.0 / q - (1.0 / q) * decay
    eye = torch.eye(q, dtype=torch.float32, device=t.device)
    return diff + (same - diff) * eye


def gtr_generator(rates, freqs) -> torch.Tensor:
    """Normalised reversible (GTR) rate matrix: off-diagonals ``s_ij * pi_j``,
    rows summing to 0, one expected substitution per unit branch length."""
    rates, freqs = _f32(rates), _f32(freqs, device=_f32(rates).device)
    sym = (rates + rates.T) / 2.0
    gen = sym * freqs[None, :]
    gen = gen - torch.diag(torch.diag(gen))
    gen = gen - torch.diag(gen.sum(dim=1))
    scale = -(freqs * torch.diag(gen)).sum()
    return gen / scale


@highest_matmul_precision
def gtr_eigensystem(rates, freqs) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(eigenvalues (Q,), left (Q, Q), right (Q, Q)) of the normalised GTR
    generator, with ``P(t) = right @ diag(exp(eigenvalues * t)) @ left``
    (``torch.linalg.eigh`` of the pi-symmetrised generator)."""
    freqs = _f32(freqs)
    gen = gtr_generator(rates, freqs)
    sqrt_pi = torch.sqrt(freqs)
    balanced = sqrt_pi[:, None] * gen / sqrt_pi[None, :]
    eigvals, eigvecs = torch.linalg.eigh((balanced + balanced.T) / 2.0)
    right = eigvecs / sqrt_pi[:, None]
    left = eigvecs.T * sqrt_pi[None, :]
    return eigvals, left, right


@highest_matmul_precision
def gtr_transition(branch_length, eigvals, left, right) -> torch.Tensor:
    """(Q, Q) transition matrix from a precomputed GTR eigensystem."""
    t = _f32(branch_length, device=eigvals.device)
    p = torch.matmul(right * torch.exp(eigvals * t)[None, :], left)
    return torch.clamp(p, 0.0, 1.0)


def tip_partials(
    leaf_sequences: torch.Tensor, n_states: int, sequences_are_masks: bool
) -> torch.Tensor:
    """(n_leaves, Q, L) f32 tip partials: 1 at every allowed state.

    Masks allow their set bits; integer states allow themselves, and a
    negative (missing) state allows every state.
    """
    leaves = torch.as_tensor(leaf_sequences).to(torch.int32)[:, None, :]
    states = torch.arange(n_states, dtype=torch.int32, device=leaves.device)[None, :, None]
    if sequences_are_masks:
        allowed = ((leaves >> states) & 1) == 1
    else:
        allowed = (leaves == states) | (leaves < 0)
    return allowed.to(torch.float32)


def fixed_length_model(n_states: int, length: float, rates, freqs, device):
    """(P (Q, Q), root prior (Q,)) of every branch at one ``length``: the
    ranking model of the ML climbs. JC69 when ``rates`` and ``freqs`` are
    both None, else GTR (missing ``rates``: all exchangeabilities 1;
    missing ``freqs``: uniform), its P the matrix exponential of the
    generator in float64: the JAX package's float32 eigensystem leaves the
    small entries of a 61-state P wrong by up to their own size (8e-6 of a
    codon log-likelihood at 64 taxa x 1000 codons), and differently on the
    card and the CPU."""
    q = n_states
    prior = (
        torch.full((q,), 1.0 / q, dtype=torch.float32, device=device)
        if freqs is None else _f32(freqs, device=device)
    )
    if rates is None and freqs is None:
        return jc69_transition(torch.tensor(float(length), device=device), q), prior
    model_rates = (
        torch.ones((q, q), device=device) - torch.eye(q, device=device)
        if rates is None else _f32(rates, device=device)
    )
    gen = gtr_generator(model_rates, prior).to(torch.float64)
    p = torch.linalg.matrix_exp(gen * float(length)).clamp(0.0, 1.0)
    return p.to(torch.float32), prior


def _model(n_states: int, rates, freqs, device):
    """(P(t) callable on a length tensor, (Q,) root prior) of JC69 or GTR."""
    q = n_states
    if rates is None and freqs is None:
        prior = torch.full((q,), 1.0 / q, dtype=torch.float32, device=device)
        return (lambda t: jc69_transition(t, q)), prior
    freqs = (
        torch.full((q,), 1.0 / q, dtype=torch.float32, device=device)
        if freqs is None else _f32(freqs, device=device)
    )
    rates = (
        torch.ones((q, q), dtype=torch.float32, device=device)
        if rates is None else _f32(rates, device=device)
    )
    gen = gtr_generator(rates, freqs)
    # matrix_exp, as the reference's expm (eigh is ill-defined at
    # degenerate spectra).
    return (lambda t: torch.linalg.matrix_exp(gen * t[..., None, None])), freqs


def batched_tree_log_likelihood(
    topologies: Topology,
    branch_lengths,
    leaf_sequences,
    n_states: int,
    site_mask=None,
    rates=None,
    freqs=None,
    *,
    sequences_are_masks: bool = False,
) -> torch.Tensor:
    """(B,) log-likelihoods of a batch of trees with (B, n_all) lengths,
    one pruning pass a tree."""
    lengths = _f32(branch_lengths)
    return torch.stack([
        tree_log_likelihood(
            Topology(topologies.children[b], topologies.parents[b]), lengths[b],
            leaf_sequences, n_states, site_mask, rates, freqs,
            sequences_are_masks=sequences_are_masks,
        )
        for b in range(topologies.children.shape[0])
    ])


def tree_log_likelihood(
    topology: Topology,
    branch_lengths,
    leaf_sequences,
    n_states: int,
    site_mask=None,
    rates=None,
    freqs=None,
    *,
    sequences_are_masks: bool = False,
) -> torch.Tensor:
    """Log-likelihood (0-d f32) of the alignment given one topology and its
    (n_all,) branch lengths (the length above each node; the root's is
    ignored).

    ``leaf_sequences``: (n_leaves, L) integer states (negative = missing),
    or int32 state-set bitmasks with ``sequences_are_masks=True``.
    ``rates``/``freqs``: optional GTR exchangeabilities (Q, Q) and
    stationary frequencies (Q,); both None is JC69 with a uniform prior.
    ``site_mask``: optional (L,) per-site weights.
    """
    return _masked_sum(
        _per_site_log_likelihood(topology, branch_lengths, leaf_sequences, n_states, rates,
                                 freqs, sequences_are_masks),
        site_mask,
    )


# ---------------------------------------------------------------------------
# Rate heterogeneity, the differentiable per-site pruning and model fitting
# (the rest of ``trex_tpu/ops/likelihood.py``).


def discrete_gamma_rates(shape, n_categories: int) -> torch.Tensor:
    """(K,) mean rates of ``n_categories`` equal-probability Gamma(shape,
    1/shape) categories (Yang 1994), normalised to mean 1.

    Quantile boundaries come from the Wilson-Hilferty chi-square
    approximation (smooth in ``shape``); each category's rate is that of
    its probability slice's midpoint, floored at 1e-6.
    """
    k = n_categories
    shape = _f32(shape)
    probs = (torch.arange(k, dtype=torch.float32, device=shape.device) + 0.5) / k
    df = 2.0 * shape
    z = math.sqrt(2.0) * torch.erfinv(2.0 * probs - 1.0)
    chi2 = df * (1.0 - 2.0 / (9.0 * df) + z * torch.sqrt(2.0 / (9.0 * df))) ** 3
    rates = torch.clamp(chi2 / df, min=1e-6)
    return rates / rates.mean()


@dataclasses.dataclass
class _Level:
    """One height of ``Levels``: its ``size`` ancestors, in the order of
    their output rows."""

    size: int
    nodes: torch.Tensor
    """(2 size,) the children (the first children, then the second), whose
    branches' transition matrices they take."""
    tip_rows: torch.Tensor | None
    """The children that are leaves, as rows of the tip partials."""
    sources: list[int]
    """The lower levels whose pieces hold the other children, ascending."""
    perm: torch.Tensor | None
    """Rows of (tips, then the sources' pieces) in the order of ``nodes``;
    None where that order is already theirs."""
    consumers: list[int]
    """The higher levels that read this level's rows, ascending."""
    piece_sizes: list[int]
    """The output rows each consumer reads (contiguous, in that order)."""


class Levels:
    """The ancestors of one topology grouped by height, for pruning a level
    at a time: every ancestor of a level depends only on lower levels.

    Each level's output rows are ordered by the level of their parent and
    split into one piece per consuming level, so every piece is read by one
    later level only: no pass gathers from (or, under autograd, zero-fills
    the gradient of) a table of all rows, and a pass's memory traffic stays
    linear in the tree on deep (caterpillar) trees too. Levels are ordered
    from the root down, each ancestor by its parent's level and its place
    among that level's children, so a level whose children all come from
    one lower level reads that level's piece as it lies.
    """

    def __init__(self, children: torch.Tensor, device) -> None:
        pairs = torch.as_tensor(children).cpu().tolist()
        n_leaves = len(pairs) + 1
        height = [0] * (n_leaves + len(pairs))
        parent = [None] * (n_leaves + len(pairs))
        by_height: dict[int, list[int]] = {}
        for a, (c1, c2) in enumerate(pairs):
            v = n_leaves + a
            height[v] = h = 1 + max(height[c1], height[c2])
            parent[c1] = parent[c2] = v
            by_height.setdefault(h, []).append(v)
        top = max(by_height)
        order: dict[int, list[int]] = {}
        kid_pos: dict[int, int] = {}
        for h in range(top, 0, -1):
            order[h] = sorted(by_height.get(h, ()), key=lambda v: (
                height[parent[v]] if parent[v] is not None else top + 1, kid_pos.get(v, 0)))
            kids = self._kids(pairs, n_leaves, order[h])
            kid_pos.update((c, i) for i, c in enumerate(kids))

        def as_index(values):
            return torch.tensor(values, dtype=torch.int64).to(device)

        self.levels: list[_Level] = []
        for h in range(1, top + 1):
            kids = self._kids(pairs, n_leaves, order[h])
            tips = [c for c in kids if c < n_leaves]
            sources = sorted({height[c] for c in kids if c >= n_leaves})
            gathered = tips + [v for j in sources for v in order[j] if height[parent[v]] == h]
            where = {v: i for i, v in enumerate(gathered)}
            perm = [where[c] for c in kids]
            consumers = [height[parent[v]] for v in order[h] if parent[v] is not None]
            levels = sorted(set(consumers))
            self.levels.append(_Level(
                size=len(order[h]),
                nodes=as_index(kids),
                tip_rows=as_index(tips) if tips else None,
                sources=sources,
                perm=None if perm == list(range(len(perm))) else as_index(perm),
                consumers=levels,
                piece_sizes=[consumers.count(g) for g in levels],
            ))

    @staticmethod
    def _kids(pairs, n_leaves: int, ancestors: list[int]) -> list[int]:
        return ([pairs[v - n_leaves][0] for v in ancestors]
                + [pairs[v - n_leaves][1] for v in ancestors])


def _level_pruning(levels: Levels, pmats: torch.Tensor, tips: torch.Tensor,
                   root_prior: torch.Tensor) -> torch.Tensor:
    """(K, L) per-site log-likelihoods of K pruning passes over one tree.

    ``pmats``: (K, n_all, Q, Q) transition matrix of the branch above each
    node in each pass (the categories of a rate mixture); ``tips``:
    (n_leaves, Q, L). Each ancestor's partial is ``(P_c1 d_c1) * (P_c2
    d_c2)`` divided per site by its maximum (floored at 1e-30), as in the
    reference; a level's ancestors are computed together, out of place, so
    autograd keeps a few graph nodes a level and no in-place writes.
    """
    k = pmats.shape[0]
    pieces: dict[tuple[int, int], torch.Tensor] = {}
    scales = []
    for h, level in enumerate(levels.levels, start=1):
        parts = [pieces.pop((j, h)) for j in level.sources]
        if level.tip_rows is not None:
            parts.insert(0, tips.index_select(0, level.tip_rows).expand(k, -1, -1, -1))
        gathered = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
        if level.perm is not None:
            gathered = gathered.index_select(1, level.perm)
        messages = torch.matmul(pmats.index_select(1, level.nodes), gathered)
        m = level.size
        combined = messages[:, :m] * messages[:, m:]
        scales.append(torch.clamp(combined.amax(dim=2), min=1e-30))
        rows = combined / scales[-1][:, :, None]
        if level.consumers:
            pieces.update(((h, g), piece) for g, piece in
                          zip(level.consumers, rows.split(level.piece_sizes, dim=1)))
    logscale = torch.log(torch.cat(scales, dim=1)).sum(dim=1)
    site_lik = (root_prior[:, None] * rows[:, -1]).sum(dim=1)
    # The floor keeps a zero-probability site (a variable site in a rate-0
    # class) finite, with a zero gradient instead of NaN.
    return torch.log(torch.clamp(site_lik, min=1e-30)) + logscale


@highest_matmul_precision
def _category_log_likelihoods(
    topology: Topology,
    branch_lengths,
    leaf_sequences,
    n_states: int,
    category_rates=None,
    rates=None,
    freqs=None,
    sequences_are_masks: bool = False,
    levels: Levels | None = None,
) -> torch.Tensor:
    """(K, L) per-site log-likelihoods with every branch length scaled by
    each of the K ``category_rates`` (None: one category at rate 1), as one
    pruning pass over a leading category axis."""
    leaves = torch.as_tensor(leaf_sequences)
    device = leaves.device
    tips = tip_partials(leaves, n_states, sequences_are_masks)
    transition, prior = _model(n_states, rates, freqs, device)
    lengths = _f32(branch_lengths, device=device)
    if category_rates is None:
        scaled = lengths[None]
    else:
        scaled = lengths[None, :] * _f32(category_rates, device=device)[:, None]
    if levels is None:
        levels = Levels(topology.children, device)
    return _level_pruning(levels, transition(scaled), tips, prior)


@highest_matmul_precision
def _per_site_log_likelihood(
    topology: Topology,
    branch_lengths,
    leaf_sequences,
    n_states: int,
    rates=None,
    freqs=None,
    sequences_are_masks: bool = False,
    transition_matrices=None,
    root_prior=None,
) -> torch.Tensor:
    """(L,) per-site log-likelihoods, differentiable in the lengths and the
    model. ``transition_matrices`` ((n_all, Q, Q), one P a branch) replaces
    the model arguments; it needs ``root_prior``."""
    if transition_matrices is None:
        return _category_log_likelihoods(
            topology, branch_lengths, leaf_sequences, n_states, None, rates, freqs,
            sequences_are_masks,
        )[0]
    if root_prior is None:
        raise ValueError("transition_matrices requires root_prior")
    leaves = torch.as_tensor(leaf_sequences)
    pmats = _f32(transition_matrices, device=leaves.device)
    return _level_pruning(
        Levels(topology.children, leaves.device), pmats[None],
        tip_partials(leaves, n_states, sequences_are_masks),
        _f32(root_prior, device=leaves.device),
    )[0]


def _masked_sum(per_site: torch.Tensor, site_mask) -> torch.Tensor:
    if site_mask is not None:
        per_site = per_site * _f32(site_mask, device=per_site.device)
    return per_site.sum()


def _gamma_mixture(per_site_k: torch.Tensor) -> torch.Tensor:
    return torch.logsumexp(per_site_k, dim=0) - math.log(per_site_k.shape[0])


def per_site_log_likelihood(
    topology: Topology,
    branch_lengths,
    leaf_sequences,
    n_states: int,
    rates=None,
    freqs=None,
    *,
    gamma_shape=None,
    n_categories: int = 4,
    sequences_are_masks: bool = False,
) -> torch.Tensor:
    """(L,) per-site log-likelihoods (RELL resampling, SH-aLRT, site-wise
    model comparison); with ``gamma_shape`` each site's value is the +G
    category mixture."""
    if gamma_shape is None:
        return _per_site_log_likelihood(
            topology, branch_lengths, leaf_sequences, n_states, rates, freqs,
            sequences_are_masks,
        )
    return _gamma_mixture(_category_log_likelihoods(
        topology, branch_lengths, leaf_sequences, n_states,
        discrete_gamma_rates(gamma_shape, n_categories), rates, freqs, sequences_are_masks,
    ))


def tree_log_likelihood_gamma(
    topology: Topology,
    branch_lengths,
    leaf_sequences,
    n_states: int,
    gamma_shape=1.0,
    n_categories: int = 4,
    site_mask=None,
    rates=None,
    freqs=None,
    *,
    sequences_are_masks: bool = False,
    levels: Levels | None = None,
) -> torch.Tensor:
    """Log-likelihood under discrete-Gamma rate heterogeneity (+G): each
    site's likelihood is the equal-weight mixture over ``n_categories``
    rate categories. Differentiable in the lengths, the shape and the
    model."""
    per_site_k = _category_log_likelihoods(
        topology, branch_lengths, leaf_sequences, n_states,
        discrete_gamma_rates(gamma_shape, n_categories), rates, freqs,
        sequences_are_masks, levels,
    )
    return _masked_sum(_gamma_mixture(per_site_k), site_mask)


def tree_log_likelihood_freerate(
    topology: Topology,
    branch_lengths,
    leaf_sequences,
    n_states: int,
    category_rates,
    category_weights,
    site_mask=None,
    rates=None,
    freqs=None,
    *,
    sequences_are_masks: bool = False,
    levels: Levels | None = None,
) -> torch.Tensor:
    """FreeRate (+R): a K-category mixture with free rates and weights. The
    caller normalises ``sum_k w_k r_k == 1`` (``optimize_model`` does)."""
    per_site_k = _category_log_likelihoods(
        topology, branch_lengths, leaf_sequences, n_states, category_rates, rates,
        freqs, sequences_are_masks, levels,
    )
    log_w = torch.log(torch.clamp(_f32(category_weights), min=1e-30))[:, None]
    return _masked_sum(torch.logsumexp(per_site_k + log_w, dim=0), site_mask)


def _invariant_log_likelihood(leaf_sequences, n_states: int, freqs, sequences_are_masks: bool):
    """(L,) log-likelihood of the rate-0 class in closed form: the prior
    mass of the states every leaf allows (floored at 1e-30)."""
    leaves = torch.as_tensor(leaf_sequences)
    q = n_states
    prior = (
        torch.full((q,), 1.0 / q, dtype=torch.float32, device=leaves.device)
        if freqs is None else _f32(freqs, device=leaves.device)
    )
    shared = tip_partials(leaves, q, sequences_are_masks).amin(dim=0)  # (Q, L)
    return torch.log(torch.clamp((prior[:, None] * shared).sum(dim=0), min=1e-30))


def tree_log_likelihood_gamma_invariant(
    topology: Topology,
    branch_lengths,
    leaf_sequences,
    n_states: int,
    gamma_shape=1.0,
    p_invariant=0.0,
    n_categories: int = 4,
    site_mask=None,
    rates=None,
    freqs=None,
    *,
    sequences_are_masks: bool = False,
    levels: Levels | None = None,
) -> torch.Tensor:
    """+G+I: the Gamma mixture plus an invariant-sites class.

    The rate-0 class is computed in closed form, not by pruning at zero
    lengths: zero lengths make whole partial columns 0, and the
    rescaling's ``log(scale)`` backward then overflows to NaN.
    """
    per_site_k = _category_log_likelihoods(
        topology, branch_lengths, leaf_sequences, n_states,
        discrete_gamma_rates(gamma_shape, n_categories), rates, freqs,
        sequences_are_masks, levels,
    )
    inv_ll = _invariant_log_likelihood(leaf_sequences, n_states, freqs, sequences_are_masks)
    p_inv = torch.clamp(_f32(p_invariant), 1e-9, 1.0 - 1e-9)
    mixed = torch.logaddexp(
        torch.log(p_inv) + inv_ll, torch.log1p(-p_inv) + _gamma_mixture(per_site_k)
    )
    return _masked_sum(mixed, site_mask)


def optimize_branch_lengths(
    topology: Topology,
    leaf_sequences,
    n_states: int,
    *,
    init_length: float = 0.1,
    learning_rate: float = 0.05,
    n_iterations: int = 500,
    sequences_are_masks: bool = False,
    site_weights=None,
    rates=None,
    freqs=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """ML branch lengths on a fixed topology by Adam on softplus(theta)
    lengths (no clipping, as the reference's ``optax.adam``).

    Returns (branch_lengths (n_all,), loss curve (n_iterations,)), the loss
    taken before each step.
    """
    from trex_tpu_torch.search.optimizers import make_optimizer

    leaves = torch.as_tensor(leaf_sequences)
    device = leaves.device
    levels = Levels(topology.children, device)
    theta = torch.full(
        (topology.n_all,), float(_softplus_inverse(init_length)), device=device
    ).requires_grad_(True)
    optimizer = make_optimizer("adam", learning_rate, [theta], clip_global_norm=None)
    losses = torch.empty((n_iterations,), dtype=torch.float32, device=device)
    for step in range(n_iterations):
        optimizer.zero_grad()
        per_site = _category_log_likelihoods(
            topology, torch.nn.functional.softplus(theta), leaves, n_states, None, rates,
            freqs, sequences_are_masks, levels,
        )[0]
        loss = -_masked_sum(per_site, site_weights)
        loss.backward()
        losses[step] = loss.detach()
        optimizer.step()
    return torch.nn.functional.softplus(theta.detach()), losses


def _softplus_inverse(x) -> torch.Tensor:
    """log(expm1(x)) in float32, the reference's unconstrained initial value."""
    return torch.log(torch.expm1(torch.tensor(x, dtype=torch.float32)))


_MODEL_GRAMMAR = re.compile(
    r"(jc|k80|hky|f81|tn93|gtr|empirical)(?:(\+g)?(\+i)?|(\+r([2-8])))?"
)


def _parse_model_string(model: str) -> dict:
    """Parse ``<base>[+g][+i] | <base>+rK`` into a spec.

    Bases: jc | k80 | hky | f81 | tn93 | gtr | empirical. The named
    nucleotide models are constrained GTR submodels (DNA order ACGT;
    transitions A<->G and C<->T): K80 one kappa and equal frequencies,
    HKY85 kappa and free frequencies, F81 equal exchangeabilities and free
    frequencies, TN93 separate purine and pyrimidine transition rates and
    free frequencies; they need n_states == 4. ``+rK``: FreeRate, K in 2..8.
    """
    m = _MODEL_GRAMMAR.fullmatch(model.lower())
    if not m:
        raise ValueError(f"unknown model {model!r}")
    base = m.group(1)
    return {
        "model": model.lower(),
        "base": base,
        "use_gtr": base == "gtr",
        "use_fixed": base == "empirical",
        "use_kappa": base in ("k80", "hky"),
        "use_tn": base == "tn93",
        "free_freqs": base in ("hky", "f81", "tn93"),
        "use_gamma": bool(m.group(2)),
        "use_inv": bool(m.group(3)),
        "n_free": int(m.group(5)) if m.group(5) else 0,
    }


def _init_model_params(spec: dict, q: int, fixed_freqs=None, device=None) -> dict:
    """Initial unconstrained substitution-model parameters (no lengths), as
    float32 tensors with the reference's values."""
    def zeros(n):
        return torch.zeros((n,), dtype=torch.float32, device=device)

    def inverse(x):
        return _softplus_inverse(x).to(device)

    params: dict = {}
    if spec["use_gtr"]:
        n_pairs = q * (q - 1) // 2
        # Slightly off uniform, as the reference starts.
        params["theta_rates"] = 0.01 * torch.arange(
            1, n_pairs, dtype=torch.float32, device=device)
        params["logit_freqs"] = zeros(q)
    if spec["use_fixed"] and fixed_freqs is None:
        params["logit_freqs"] = zeros(q)
    if (spec["use_kappa"] or spec["use_tn"] or spec["base"] == "f81") and q != 4:
        raise ValueError(
            f"model {spec['model']!r} is a nucleotide model (needs n_states == 4, got {q})"
        )
    if spec["use_kappa"]:
        params["theta_kappa"] = inverse(2.0)
    if spec["use_tn"]:
        params["theta_kappa_r"] = inverse(2.0)
        params["theta_kappa_y"] = inverse(2.0)
    if spec["free_freqs"]:
        params["logit_freqs"] = zeros(q)
    if spec["use_gamma"]:
        params["theta_shape"] = inverse(1.0)
    if spec["use_inv"]:
        params["logit_inv"] = torch.tensor(-2.0, device=device)
    if spec["n_free"]:
        # Rates spread over a decade, so the categories differentiate.
        init_rates = torch.as_tensor(
            np.geomspace(0.2, 3.0, spec["n_free"]), dtype=torch.float32)
        params["theta_cat_rates"] = torch.log(torch.expm1(init_rates)).to(device)
        params["logit_cat_weights"] = zeros(spec["n_free"])
    return params


def _build_model_params(spec: dict, params: dict, q: int, fixed_rates=None, fixed_freqs=None):
    """(constrained parameters, rates, freqs) from unconstrained ones."""
    softplus = torch.nn.functional.softplus
    out: dict = {}
    rates = freqs = None
    if spec["use_fixed"]:
        rates = fixed_rates
        freqs = fixed_freqs if fixed_freqs is not None else torch.softmax(params["logit_freqs"], 0)
        out["rates"] = rates
        out["freqs"] = freqs
    if spec["use_gtr"]:
        theta = params["theta_rates"]
        pair_i, pair_j = torch.triu_indices(q, q, offset=1, device=theta.device)
        # The last exchangeability is pinned to 1 (identifiability).
        pair_rates = torch.cat([softplus(theta), torch.ones((1,), device=theta.device)])
        rates = torch.zeros((q, q), dtype=torch.float32, device=theta.device).index_put(
            (pair_i, pair_j), pair_rates)
        rates = rates + rates.T
        freqs = torch.softmax(params["logit_freqs"], 0)
        out["rates"] = rates
        out["freqs"] = freqs
    if spec["use_kappa"] or spec["use_tn"] or spec["base"] == "f81":
        # DNA order ACGT: transitions A<->G (0, 2) and C<->T (1, 3);
        # transversions pinned at 1.
        device = next(iter(params.values())).device if params else None
        if spec["use_tn"]:
            k_r = softplus(params["theta_kappa_r"])
            k_y = softplus(params["theta_kappa_y"])
            out["kappa_purine"] = k_r
            out["kappa_pyrimidine"] = k_y
        elif spec["use_kappa"]:
            k_r = k_y = softplus(params["theta_kappa"])
            out["kappa"] = k_r
        else:  # f81
            k_r = k_y = torch.tensor(1.0, device=device)
        eye = torch.eye(q, dtype=torch.float32, device=device)
        purine = torch.zeros((q, q), dtype=torch.bool, device=device)
        purine[0, 2] = purine[2, 0] = True
        pyrimidine = torch.zeros((q, q), dtype=torch.bool, device=device)
        pyrimidine[1, 3] = pyrimidine[3, 1] = True
        rates = torch.where(purine, k_r, torch.where(pyrimidine, k_y, 1.0 - eye))
        freqs = (
            torch.softmax(params["logit_freqs"], 0) if spec["free_freqs"]
            else torch.full((q,), 1.0 / q, dtype=torch.float32, device=device)
        )
        out["rates"] = rates
        out["freqs"] = freqs
    if spec["use_gamma"]:
        out["gamma_shape"] = softplus(params["theta_shape"])
    if spec["use_inv"]:
        out["p_invariant"] = torch.sigmoid(params["logit_inv"])
    if spec["n_free"]:
        w = torch.softmax(params["logit_cat_weights"], 0)
        r = softplus(params["theta_cat_rates"])
        r = r / (w * r).sum()  # mean rate 1: the scale lives in the lengths
        out["category_rates"] = r
        out["category_weights"] = w
    return out, rates, freqs


def _model_log_likelihood(
    spec: dict, built: dict, rates, freqs, topology: Topology, lengths, leaf_sequences,
    n_states: int, site_mask, n_categories: int, sequences_are_masks: bool,
    levels: Levels | None = None,
) -> torch.Tensor:
    """The likelihood variant of a parsed model spec."""
    common = dict(site_mask=site_mask, rates=rates, freqs=freqs,
                  sequences_are_masks=sequences_are_masks, levels=levels)
    if spec["n_free"]:
        return tree_log_likelihood_freerate(
            topology, lengths, leaf_sequences, n_states,
            built["category_rates"], built["category_weights"], **common,
        )
    if spec["use_inv"]:
        # "+i" without "+g": one rate-1 category plus the invariant class.
        return tree_log_likelihood_gamma_invariant(
            topology, lengths, leaf_sequences, n_states,
            gamma_shape=built.get("gamma_shape", 1.0), p_invariant=built["p_invariant"],
            n_categories=n_categories if spec["use_gamma"] else 1, **common,
        )
    if spec["use_gamma"]:
        return tree_log_likelihood_gamma(
            topology, lengths, leaf_sequences, n_states, gamma_shape=built["gamma_shape"],
            n_categories=n_categories, **common,
        )
    per_site = _category_log_likelihoods(
        topology, lengths, leaf_sequences, n_states, None, rates, freqs,
        sequences_are_masks, levels,
    )[0]
    return _masked_sum(per_site, site_mask)


def optimize_model(
    topology: Topology,
    leaf_sequences,
    n_states: int,
    *,
    model: str = "gtr+g",
    n_categories: int = 4,
    init_length: float = 0.1,
    learning_rate: float = 0.05,
    n_iterations: int = 800,
    sequences_are_masks: bool = False,
    site_weights=None,
    fixed_rates=None,
    fixed_freqs=None,
) -> tuple[dict, torch.Tensor]:
    """Joint ML fit of the branch lengths and the substitution model by
    ``n_iterations`` steps of Adam (``learning_rate``, no clipping) on the
    negative log-likelihood, over unconstrained parameters: softplus
    lengths, softplus exchangeabilities with the last pair pinned to 1,
    softmax frequencies, softplus Gamma shape, sigmoid invariant share,
    FreeRate rates and softmax weights normalised to mean rate 1.

    ``model``: ``<base>[+g][+i] | <base>+rK`` (``_parse_model_string``);
    ``empirical`` holds the exchangeabilities at ``fixed_rates`` (e.g.
    ``io.parse_paml_rates``) and takes ``fixed_freqs`` or fits them.

    Returns (params, losses): "branch_lengths" (n_all,), and as the model
    has them "rates", "freqs", "kappa*", "gamma_shape", "p_invariant",
    "category_rates", "category_weights"; the loss before each step.
    """
    from trex_tpu_torch.search.optimizers import make_optimizer

    spec = _parse_model_string(model)
    leaves = torch.as_tensor(leaf_sequences)
    device = leaves.device
    if spec["use_fixed"]:
        if fixed_rates is None:
            raise ValueError("model 'empirical' needs fixed_rates (e.g. io.parse_paml_rates)")
        fixed_rates = _f32(fixed_rates, device=device)
        if fixed_freqs is not None:
            fixed_freqs = _f32(fixed_freqs, device=device)
    weights = None if site_weights is None else _f32(site_weights, device=device)
    q = n_states
    levels = Levels(topology.children, device)

    def nll(params):
        built, rates, freqs = _build_model_params(spec, params, q, fixed_rates, fixed_freqs)
        built["branch_lengths"] = torch.nn.functional.softplus(params["theta_len"])
        return built, -_model_log_likelihood(
            spec, built, rates, freqs, topology, built["branch_lengths"], leaves, n_states,
            weights, n_categories, sequences_are_masks, levels,
        )

    params = _init_model_params(spec, q, fixed_freqs, device)
    params["theta_len"] = torch.full(
        (topology.n_all,), float(_softplus_inverse(init_length)), device=device)
    for value in params.values():
        value.requires_grad_(True)
    optimizer = make_optimizer("adam", learning_rate, params.values(), clip_global_norm=None)
    losses = torch.empty((n_iterations,), dtype=torch.float32, device=device)
    for step in range(n_iterations):
        optimizer.zero_grad()
        _, loss = nll(params)
        loss.backward()
        losses[step] = loss.detach()
        optimizer.step()
    with torch.no_grad():
        built, _ = nll(params)
    return {k: v.detach() if torch.is_tensor(v) else v for k, v in built.items()}, losses


def optimize_model_partitioned(
    topology: Topology,
    leaf_sequences,
    n_states: int,
    partition_ids,
    *,
    models: list[str] | tuple[str, ...],
    linked: str = "proportional",
    n_categories: int = 4,
    init_length: float = 0.1,
    learning_rate: float = 0.05,
    n_iterations: int = 800,
    sequences_are_masks: bool = False,
    site_weights=None,
    fixed_rates=None,
    fixed_freqs=None,
) -> tuple[dict, torch.Tensor]:
    """Partitioned ML: a substitution model per partition over one shared
    topology and one shared set of branch lengths.

    The log-likelihood is the sum of the partitions', each under its own
    model and over its own sites (``partition_ids`` (L,) maps each site
    or pattern to its partition 0..P-1; ``site_weights`` are the base
    counts). With ``linked="proportional"`` every partition p > 0 also
    gets a positive rate multiplier m_p on the shared lengths (softplus;
    partition 0 pinned to 1), ``"equal"`` pins every multiplier to 1.
    Lengths (softplus), multipliers and every partition's model parameters
    (``_init_model_params``/``_build_model_params``, one ``models`` string
    a partition; ``empirical`` ones share ``fixed_rates``/``fixed_freqs``)
    are fitted jointly by ``n_iterations`` steps of Adam (no clipping).

    Returns (result, losses): ``result`` maps "branch_lengths" (n_all,),
    "rate_multipliers" (P,) and "partitions", one dict a partition with
    its fitted model parameters (``optimize_model``'s keys but the
    lengths) and its "log_likelihood" at the final parameters; the loss
    before each step.
    """
    from trex_tpu_torch.search.optimizers import make_optimizer

    if linked not in ("proportional", "equal"):
        raise ValueError(f"linked must be 'proportional' or 'equal', got {linked!r}")
    pids = np.asarray(torch.as_tensor(partition_ids).cpu())
    n_parts = int(pids.max()) + 1
    if len(models) != n_parts:
        raise ValueError(f"{n_parts} partitions but {len(models)} model strings")
    specs = [_parse_model_string(m) for m in models]
    if any(spec["use_fixed"] for spec in specs) and fixed_rates is None:
        raise ValueError("'empirical' partitions need fixed_rates")
    leaves = torch.as_tensor(leaf_sequences)
    device = leaves.device
    if fixed_rates is not None:
        fixed_rates = _f32(fixed_rates, device=device)
    if fixed_freqs is not None:
        fixed_freqs = _f32(fixed_freqs, device=device)
    q = n_states
    base_weights = (
        torch.ones((pids.shape[0],), dtype=torch.float32, device=device)
        if site_weights is None else _f32(site_weights, device=device)
    )
    # Each partition is pruned over its own columns only (the JAX package
    # prunes every site under a zeroed mask: the same sum in another order).
    columns = [torch.as_tensor(np.flatnonzero(pids == p), device=device)
               for p in range(n_parts)]
    part_leaves = [leaves[:, c].contiguous() for c in columns]
    part_weights = [base_weights[c] for c in columns]
    proportional = linked == "proportional" and n_parts > 1
    levels = Levels(topology.children, device)

    def part_lls(params):
        lengths = torch.nn.functional.softplus(params["theta_len"])
        mult = torch.ones((n_parts,), dtype=torch.float32, device=device)
        if proportional:
            mult = torch.cat([mult[:1], torch.nn.functional.softplus(params["theta_mult"])])
        parts, lls = [], []
        for p, spec in enumerate(specs):
            built, rates, freqs = _build_model_params(spec, params[f"part{p}"], q, fixed_rates,
                                                      fixed_freqs)
            parts.append(built)
            lls.append(_model_log_likelihood(
                spec, built, rates, freqs, topology, lengths * mult[p], part_leaves[p],
                n_states, part_weights[p], n_categories, sequences_are_masks, levels,
            ))
        return lengths, mult, parts, lls

    params: dict = {"theta_len": torch.full(
        (topology.n_all,), float(_softplus_inverse(init_length)), device=device)}
    if proportional:
        params["theta_mult"] = torch.full(
            (n_parts - 1,), float(_softplus_inverse(1.0)), device=device)
    for p, spec in enumerate(specs):
        params[f"part{p}"] = _init_model_params(spec, q, fixed_freqs, device)
    leaves_of = [params["theta_len"]] + ([params["theta_mult"]] if proportional else []) + [
        value for p in range(n_parts) for value in params[f"part{p}"].values()]
    for value in leaves_of:
        value.requires_grad_(True)
    optimizer = make_optimizer("adam", learning_rate, leaves_of, clip_global_norm=None)
    losses = torch.empty((n_iterations,), dtype=torch.float32, device=device)
    for step in range(n_iterations):
        optimizer.zero_grad()
        loss = -sum(part_lls(params)[3])
        loss.backward()
        losses[step] = loss.detach()
        optimizer.step()
    with torch.no_grad():
        lengths, mult, parts, lls = part_lls(params)
    result = {
        "branch_lengths": lengths,
        "rate_multipliers": mult,
        "partitions": [
            {**{k: v.detach() if torch.is_tensor(v) else v for k, v in parts[p].items()},
             "log_likelihood": lls[p]}
            for p in range(n_parts)
        ],
    }
    return result, losses


def _param_keys(spec: dict) -> set[str]:
    """Names of a model's parameters: constrained (``optimize_model``'s
    output) and unconstrained (its pytree)."""
    keys = {"branch_lengths", "theta_len"}
    if spec["use_gtr"] or spec["use_fixed"] or spec["use_kappa"] or spec["use_tn"] \
            or spec["base"] == "f81":
        keys |= {"rates", "freqs"}
    if spec["use_gtr"]:
        keys.add("theta_rates")
    if spec["use_gtr"] or spec["use_fixed"] or spec["free_freqs"]:
        keys.add("logit_freqs")
    if spec["use_kappa"]:
        keys |= {"kappa", "theta_kappa"}
    if spec["use_tn"]:
        keys |= {"kappa_purine", "kappa_pyrimidine", "theta_kappa_r", "theta_kappa_y"}
    if spec["use_gamma"]:
        keys |= {"gamma_shape", "theta_shape"}
    if spec["use_inv"]:
        keys |= {"p_invariant", "logit_inv"}
    if spec["n_free"]:
        keys |= {"category_rates", "category_weights", "theta_cat_rates", "logit_cat_weights"}
    return keys


def model_params_from_numpy(spec, params: dict) -> dict:
    """The port's float32 tensors of a model's parameters given as numpy
    arrays: ``optimize_model``'s output of the JAX package (constrained:
    "branch_lengths", "rates", ...) or its unconstrained pytree ("theta_*",
    "logit_*", for ``_build_model_params``), on the CPU. ``spec``: a model
    string or a parsed spec; every key must belong to that model."""
    if isinstance(spec, str):
        spec = _parse_model_string(spec)
    unknown = set(params) - _param_keys(spec)
    if unknown:
        raise ValueError(f"parameters {sorted(unknown)} do not belong to model {spec['model']!r}")
    return {
        key: None if value is None else torch.as_tensor(np.array(value, dtype=np.float32))
        for key, value in params.items()
    }


@highest_matmul_precision
def posterior_site_rates(
    topology: Topology,
    branch_lengths,
    leaf_sequences,
    n_states: int,
    gamma_shape,
    n_categories: int = 4,
    rates=None,
    freqs=None,
    *,
    category_rates=None,
    category_weights=None,
    sequences_are_masks: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Posterior mean substitution rate per site under a rate mixture (the
    empirical-Bayes site rate): discrete-Gamma categories, or the explicit
    ``category_rates``/``category_weights`` (FreeRate). Each site's
    posterior over categories is ``w_k L_k(s)``, normalised.

    Returns (mean_rates (L,), posteriors (K, L)).
    """
    device = torch.as_tensor(leaf_sequences).device
    if category_rates is not None:
        cat = _f32(category_rates, device=device)
        prior_w = (
            _f32(category_weights, device=device) if category_weights is not None
            else torch.full((cat.shape[0],), 1.0 / cat.shape[0], device=device)
        )
    else:
        cat = discrete_gamma_rates(_f32(gamma_shape, device=device), n_categories)
        prior_w = torch.full((n_categories,), 1.0 / n_categories, device=device)
    prior_w = prior_w / prior_w.sum()
    ll_k = _category_log_likelihoods(
        topology, branch_lengths, leaf_sequences, n_states, cat, rates, freqs,
        sequences_are_masks,
    )
    log_post = ll_k + torch.log(prior_w)[:, None]
    log_post = log_post - torch.logsumexp(log_post, dim=0, keepdim=True)
    post = torch.exp(log_post)
    return (post * cat[:, None]).sum(dim=0), post
