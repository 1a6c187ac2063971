"""Codon substitution models: Goldman-Yang 1994 (counterpart of
``trex_tpu/models/codon.py``).

GY94 treats each of the 61 sense codons of the standard genetic code as one
state of a reversible continuous-time Markov chain whose exchangeabilities
are

    s_ij = 0                                   if codons i, j differ at >1 position
           1                                   synonymous transversion
           kappa                               synonymous transition
           omega                               nonsynonymous transversion
           kappa * omega                       nonsynonymous transition

with stationary codon frequencies pi (F61 empirical, F3x4 or F1x4). Since s
is symmetric, GY94 is a reversible GTR model on 61 states
(``ops.likelihood.gtr_generator``), so codon likelihoods go through the
port's pruning at Q = 61, and a tree's candidates through K3/K4 at Q = 61.

omega (dN/dS) is the quantity of interest: omega < 1 purifying selection,
omega = 1 neutral, omega > 1 positive selection. ``optimize_gy94`` fits
branch lengths, kappa and omega (and a Gamma shape) by Adam, as
``ops.likelihood.optimize_model`` fits a nucleotide model.
"""

from __future__ import annotations

import numpy as np
import torch

from trex_tpu_torch.ops.likelihood import (
    Levels,
    _category_log_likelihoods,
    _f32,
    _masked_sum,
    _softplus_inverse,
    gtr_generator,
    tree_log_likelihood_gamma,
)
from trex_tpu_torch.topology import Topology

# Engine nucleotide order (io.DNA): A=0, C=1, G=2, T=3.
_NUC = "ACGT"

# Standard genetic code, textbook layout: first/second/third base in TCAG
# order, amino acids read off the classic 64-character string.
_TCAG = "TCAG"
_AA64 = "FFLLSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG"

GENETIC_CODE: dict[str, str] = {
    b1 + b2 + b3: _AA64[16 * i + 4 * j + k]
    for i, b1 in enumerate(_TCAG)
    for j, b2 in enumerate(_TCAG)
    for k, b3 in enumerate(_TCAG)
}

STOP_CODONS = tuple(sorted(c for c, aa in GENETIC_CODE.items() if aa == "*"))

# The 61 sense codons, ordered by their ACGT base-4 index (A=0..T=3).
SENSE_CODONS: tuple[str, ...] = tuple(
    sorted(
        (c for c, aa in GENETIC_CODE.items() if aa != "*"),
        key=lambda c: tuple(_NUC.index(b) for b in c),
    )
)
N_CODONS = len(SENSE_CODONS)  # 61
CODON_INDEX: dict[str, int] = {c: i for i, c in enumerate(SENSE_CODONS)}
CODON_AMINO_ACIDS: tuple[str, ...] = tuple(GENETIC_CODE[c] for c in SENSE_CODONS)

MISSING = -1  # leaf state of an unresolvable codon (marginalised out)


def _pair_tables() -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(one_diff, is_transition, is_nonsyn) boolean (61, 61) tables."""
    codons = np.array([[_NUC.index(b) for b in c] for c in SENSE_CODONS], dtype=np.int32)
    diff = codons[:, None, :] != codons[None, :, :]  # (61, 61, 3)
    one_diff = diff.sum(axis=-1) == 1
    # The single differing position's nucleotide pair: a transition iff both
    # are purines {A, G} (0, 2) or both pyrimidines {C, T} (1, 3).
    pos = np.argmax(diff, axis=-1)
    a = np.take_along_axis(codons[:, None, :].repeat(N_CODONS, 1), pos[..., None], 2)[..., 0]
    b = np.take_along_axis(codons[None, :, :].repeat(N_CODONS, 0), pos[..., None], 2)[..., 0]
    is_transition = one_diff & (((a == 0) | (a == 2)) == ((b == 0) | (b == 2)))
    aa = np.array([ord(x) for x in CODON_AMINO_ACIDS])
    is_nonsyn = aa[:, None] != aa[None, :]
    return one_diff, is_transition, is_nonsyn


_ONE_DIFF, _IS_TRANSITION, _IS_NONSYN = _pair_tables()


def gy94_exchangeabilities(kappa, omega) -> torch.Tensor:
    """(61, 61) symmetric GY94 exchangeabilities, f32, on the device of
    ``kappa`` (a number or a tensor); differentiable in ``kappa``
    (transition/transversion ratio) and ``omega`` (dN/dS). Feed to
    ``ops.likelihood`` as ``rates`` with codon frequencies as ``freqs``."""
    kappa = _f32(kappa)
    omega = _f32(omega, device=kappa.device)
    one = torch.as_tensor(_ONE_DIFF, device=kappa.device).to(torch.float32)
    ts = torch.as_tensor(_IS_TRANSITION, device=kappa.device)
    ns = torch.as_tensor(_IS_NONSYN, device=kappa.device)
    unit = torch.ones((), device=kappa.device)
    return one * torch.where(ts, kappa, unit) * torch.where(ns, omega, unit)


def gy94_generator(kappa, omega, freqs) -> torch.Tensor:
    """Normalised GY94 rate matrix (one expected substitution per unit length)."""
    freqs = _f32(freqs)
    return gtr_generator(gy94_exchangeabilities(_f32(kappa, device=freqs.device), omega), freqs)


def _codon_lookup() -> np.ndarray:
    """(64,) sense-codon state of each ACGT base-4 codon index (-1: a stop)."""
    lut = np.full((64,), -1, dtype=np.int32)
    for state, codon in enumerate(SENSE_CODONS):
        lut[_NUC.index(codon[0]) * 16 + _NUC.index(codon[1]) * 4 + _NUC.index(codon[2])] = state
    return lut


def encode_codons(nuc_states: np.ndarray, *, stops: str = "error") -> np.ndarray:
    """(n, L) nucleotide states (0..3; negative = ambiguous/gap) -> (n, L//3)
    codon states in the SENSE_CODONS order.

    A codon with any non-ACGT position becomes ``MISSING`` (-1), which the
    likelihood marginalises out. An in-frame stop codon raises by default
    (a frame or alignment error); ``stops="missing"`` makes it missing data.
    Bases past the last full codon are dropped.
    """
    if stops not in ("error", "missing"):
        raise ValueError(f"stops must be 'error' or 'missing', got {stops!r}")
    nuc = np.asarray(nuc_states)
    n, length = nuc.shape
    n_codons = length // 3
    trimmed = nuc[:, : n_codons * 3].reshape(n, n_codons, 3)
    valid = ((trimmed >= 0) & (trimmed <= 3)).all(axis=-1)
    base4 = np.where(valid[..., None], np.clip(trimmed, 0, 3), 0)
    states = _codon_lookup()[base4[..., 0] * 16 + base4[..., 1] * 4 + base4[..., 2]]
    is_stop = valid & (states < 0)
    if is_stop.any():
        if stops == "error":
            seq, col = np.argwhere(is_stop)[0]
            raise ValueError(
                f"in-frame stop codon at sequence {seq}, codon column {col} "
                "(pass stops='missing' to treat stop codons as missing data)"
            )
        valid = valid & ~is_stop
    return np.where(valid, states, MISSING).astype(np.int32)


def empirical_codon_frequencies(codon_states: np.ndarray, *, pseudocount: float = 0.1
                                ) -> np.ndarray:
    """F61: observed codon frequencies (+pseudocount so no state has mass 0)."""
    states = np.asarray(codon_states)
    counts = np.bincount(states[states >= 0].ravel(), minlength=N_CODONS).astype(np.float64)
    counts += pseudocount
    return (counts / counts.sum()).astype(np.float32)


def _codon_products(position_freqs: np.ndarray) -> np.ndarray:
    """(61,) f32 products of per-position nucleotide frequencies ((3, 4)),
    renormalised over the sense codons."""
    freqs = np.array([
        position_freqs[0, _NUC.index(c[0])] * position_freqs[1, _NUC.index(c[1])]
        * position_freqs[2, _NUC.index(c[2])]
        for c in SENSE_CODONS
    ])
    return (freqs / freqs.sum()).astype(np.float32)


def _nucleotide_freqs(column: np.ndarray) -> np.ndarray:
    column = column[(column >= 0) & (column <= 3)]
    counts = np.bincount(column.ravel(), minlength=4).astype(np.float64) + 0.1
    return counts / counts.sum()


def f3x4_frequencies(nuc_states: np.ndarray) -> np.ndarray:
    """F3x4: product of per-codon-position nucleotide frequencies, stop mass
    removed and renormalised over the 61 sense codons."""
    nuc = np.asarray(nuc_states)
    nuc = nuc[:, : (nuc.shape[1] // 3) * 3]
    return _codon_products(np.stack([_nucleotide_freqs(nuc[:, p::3]) for p in range(3)]))


def f1x4_frequencies(nuc_states: np.ndarray) -> np.ndarray:
    """F1x4: one shared nucleotide distribution across codon positions."""
    p = _nucleotide_freqs(np.asarray(nuc_states))
    return _codon_products(np.stack([p, p, p]))


def codon_frequencies(codon_states: np.ndarray, *, mode: str = "f61",
                      nuc_states: np.ndarray | None = None) -> np.ndarray:
    """F61 / F3x4 / F1x4 (the latter two need the nucleotide alignment)."""
    mode = mode.lower()
    if mode == "f61":
        return empirical_codon_frequencies(codon_states)
    if mode in ("f3x4", "f1x4"):
        if nuc_states is None:
            raise ValueError(f"{mode} frequencies need nuc_states")
        return (f3x4_frequencies if mode == "f3x4" else f1x4_frequencies)(nuc_states)
    raise ValueError(f"unknown codon frequency mode {mode!r}")


def simulate_gy94(seed: int, topology: Topology, branch_lengths: np.ndarray, *,
                  kappa: float = 2.0, omega: float = 0.5, freqs: np.ndarray | None = None,
                  n_sites: int = 200) -> np.ndarray:
    """(n_leaves, n_sites) int32 codon states simulated down ``topology``
    under GY94: the root from the stationary distribution, each child
    through expm(Q t), on the host (numpy and ``scipy.linalg.expm``) from
    ``np.random.default_rng(seed)``. The JAX package's ``simulate_gy94``
    draws its numpy seed from its key (``jax.random.randint(key, (), 0,
    2**31 - 1)``); given that seed the two return the same states."""
    import scipy.linalg

    if freqs is None:
        freqs = np.full((N_CODONS,), 1.0 / N_CODONS, dtype=np.float64)
    freqs = np.asarray(freqs, dtype=np.float64)
    freqs = freqs / freqs.sum()
    gen = gy94_generator(float(kappa), float(omega), freqs).numpy().astype(np.float64)
    blens = np.asarray(branch_lengths, dtype=np.float64)
    children = topology.children.cpu().numpy()
    n_leaves = children.shape[0] + 1
    rng = np.random.default_rng(int(seed))
    states = np.zeros((2 * n_leaves - 1, n_sites), dtype=np.int64)
    states[-1] = rng.choice(N_CODONS, size=n_sites, p=freqs)
    # Root first: reverse index order keeps parents before children.
    for anc in range(n_leaves - 2, -1, -1):
        parent = n_leaves + anc
        for child in children[anc]:
            p = scipy.linalg.expm(gen * blens[child])
            p = np.clip(p, 0.0, None)
            p = p / p.sum(axis=1, keepdims=True)
            cum = np.cumsum(p[states[parent]], axis=1)
            u = rng.random(n_sites)[:, None]
            states[child] = (u > cum).sum(axis=1)
    return states[:n_leaves].astype(np.int32)


def gy94_log_likelihood(topology: Topology, branch_lengths, codon_states, *, kappa, omega,
                        freqs, gamma_shape=None, n_categories: int = 4, site_weights=None,
                        levels: Levels | None = None) -> torch.Tensor:
    """Log-likelihood (0-d f32) of a codon alignment under GY94 (+G with
    ``gamma_shape``), differentiable in the lengths, kappa, omega and the
    shape; ``levels``: the tree's ``ops.likelihood.Levels``, when the
    caller keeps them across calls."""
    leaves = torch.as_tensor(codon_states)
    freqs = _f32(freqs, device=leaves.device)
    rates = gy94_exchangeabilities(_f32(kappa, device=leaves.device), omega)
    if gamma_shape is None:
        per_site = _category_log_likelihoods(
            topology, branch_lengths, leaves, N_CODONS, None, rates, freqs, False, levels)[0]
        return _masked_sum(per_site, site_weights)
    return tree_log_likelihood_gamma(
        topology, branch_lengths, leaves, N_CODONS, gamma_shape=gamma_shape,
        n_categories=n_categories, site_mask=site_weights, rates=rates, freqs=freqs,
        levels=levels,
    )


def optimize_gy94(topology: Topology, codon_states, *, freqs=None, model: str = "gy94",
                  n_categories: int = 4, init_length: float = 0.1,
                  learning_rate: float = 0.05, n_iterations: int = 600,
                  site_weights=None) -> tuple[dict, torch.Tensor]:
    """Joint ML fit of branch lengths, kappa and omega (and, for
    ``model="gy94+g"``, a Gamma shape) by ``n_iterations`` steps of Adam
    (``learning_rate``, no clipping) on softplus parameters, on the device
    of ``codon_states``. Codon frequencies are held at ``freqs`` (default:
    their F61 estimate), nuisance parameters estimated by counting.

    Returns (params, losses): params maps "branch_lengths" (n_all,),
    "kappa", "omega" (0-d), "freqs" (61,), plus "gamma_shape" for +g;
    losses: the negative log-likelihood before each step.
    """
    from trex_tpu_torch.search.optimizers import make_optimizer

    model = model.lower()
    if model not in ("gy94", "gy94+g"):
        raise ValueError(f"unknown codon model {model!r}")
    use_gamma = model.endswith("+g")
    leaves = torch.as_tensor(codon_states)
    device = leaves.device
    if freqs is None:
        freqs = empirical_codon_frequencies(leaves.cpu().numpy())
    freqs_t = _f32(freqs, device=device)
    weights = None if site_weights is None else _f32(site_weights, device=device)
    levels = Levels(topology.children, device)
    softplus = torch.nn.functional.softplus

    def build(params):
        out = {"branch_lengths": softplus(params["theta_len"]),
               "kappa": softplus(params["theta_kappa"]),
               "omega": softplus(params["theta_omega"]), "freqs": freqs_t}
        if use_gamma:
            out["gamma_shape"] = softplus(params["theta_shape"])
        return out

    def nll(params):
        built = build(params)
        return -gy94_log_likelihood(
            topology, built["branch_lengths"], leaves, kappa=built["kappa"],
            omega=built["omega"], freqs=freqs_t, gamma_shape=built.get("gamma_shape"),
            n_categories=n_categories, site_weights=weights, levels=levels)

    def start(value, shape=()):
        return torch.full(shape, float(_softplus_inverse(value)), device=device)

    params = {"theta_len": start(init_length, (topology.n_all,)),
              "theta_kappa": start(2.0), "theta_omega": start(0.5)}
    if use_gamma:
        params["theta_shape"] = start(1.0)
    for value in params.values():
        value.requires_grad_(True)
    optimizer = make_optimizer("adam", learning_rate, params.values(), clip_global_norm=None)
    losses = torch.empty((n_iterations,), dtype=torch.float32, device=device)
    for step in range(n_iterations):
        optimizer.zero_grad()
        loss = nll(params)
        loss.backward()
        losses[step] = loss.detach()
        optimizer.step()
    with torch.no_grad():
        return build(params), losses
