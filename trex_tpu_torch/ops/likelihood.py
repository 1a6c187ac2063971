"""Felsenstein pruning likelihood (counterpart of ``trex_tpu/ops/likelihood.py``:
the transition matrices and the lax pruning recursion).

Models: Jukes-Cantor (JC69) generalised to Q states, and reversible GTR
(symmetric exchangeabilities + stationary frequencies). Underflow is handled
as in the reference: per node, each site's partials are divided by their
maximum (floored at 1e-30) and the log of that scale is accumulated.

Everything is float32. The Q x Q transition and message products run at full
float32 (``highest_matmul_precision``): TF32-grade products move the total
log-likelihood by about 1%, which is visible to model selection.
"""

from __future__ import annotations

import functools

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
    both None, else GTR through its eigensystem (missing ``rates``: all
    exchangeabilities 1; missing ``freqs``: uniform)."""
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
    return gtr_transition(float(length), *gtr_eigensystem(model_rates, prior)), prior


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


@highest_matmul_precision
def pruning_per_site(
    children: torch.Tensor,
    pmats: torch.Tensor,
    tips: torch.Tensor,
    root_prior: torch.Tensor,
) -> torch.Tensor:
    """(B, L) per-site log-likelihoods of B trees, the reference's recursion.

    Args:
        children: (B, n_anc, 2) children of each ancestor.
        pmats: (B, n_all, Q, Q) transition matrix of the branch above each
            node.
        tips: (n_leaves, Q, L) tip partials.
        root_prior: (Q,) root state distribution.

    Each ancestor's partial is ``(P_c1 d_c1) * (P_c2 d_c2)`` divided per
    site by its maximum (floored at 1e-30); the log of the scale adds to the
    site's log-scale.
    """
    batch, n_anc, _ = children.shape
    n_leaves, q, length = tips.shape
    device = tips.device
    children = children.to(device=device, dtype=torch.int64)
    partials = torch.ones((batch, n_leaves + n_anc, q, length), dtype=torch.float32, device=device)
    partials[:, :n_leaves] = tips
    logscale = torch.zeros((batch, length), dtype=torch.float32, device=device)
    rows = torch.arange(batch, device=device)
    for a in range(n_anc):
        c1, c2 = children[:, a, 0], children[:, a, 1]
        m1 = torch.matmul(pmats[rows, c1], partials[rows, c1])
        m2 = torch.matmul(pmats[rows, c2], partials[rows, c2])
        combined = m1 * m2
        scale = torch.clamp(combined.amax(dim=1), min=1e-30)
        partials[:, n_leaves + a] = combined / scale[:, None, :]
        logscale += torch.log(scale)
    site_lik = (root_prior[None, :, None] * partials[:, -1]).sum(dim=1)
    return torch.log(torch.clamp(site_lik, min=1e-30)) + logscale


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
    """(B,) log-likelihoods of a batch of trees with (B, n_all) lengths."""
    tips = tip_partials(leaf_sequences, n_states, sequences_are_masks)
    transition, prior = _model(n_states, rates, freqs, tips.device)
    pmats = transition(_f32(branch_lengths, device=tips.device))
    per_site = pruning_per_site(topologies.children, pmats, tips, prior)
    if site_mask is not None:
        per_site = per_site * _f32(site_mask, device=per_site.device)
    return per_site.sum(dim=-1)


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
    batch = Topology(topology.children[None], topology.parents[None])
    return batched_tree_log_likelihood(
        batch, _f32(branch_lengths)[None], leaf_sequences, n_states,
        site_mask, rates, freqs, sequences_are_masks=sequences_are_masks,
    )[0]
