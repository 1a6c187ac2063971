"""Tree topology tests: KH, SH, RELL bootstrap proportions, ELW and AU
(counterpart of ``trex_tpu/search/topotest.py``).

Given one alignment and candidate topologies, which trees can the data
reject (the CONSEL / IQ-TREE topology-test workflow)? Every test reads
the same two things as the branch supports: each tree's per-site
log-likelihood row at its own Newton-fitted lengths
(``ops.likelihood_asr.per_site_matrix``) and RELL resampling, one
(replicates x patterns) @ (patterns x trees) float32 product.

Per non-best tree, against the ML tree:
- ``p_kh``: Kishino-Hasegawa via RELL, replicate totals centred at their
  observed totals;
- ``p_sh``: Shimodaira-Hasegawa, against the best of all candidates per
  replicate;
- ``bp``: the RELL bootstrap proportion;
- ``elw``: the expected likelihood weight (Strimmer & Rambaut 2002);
- ``p_au``: the approximately unbiased test (Shimodaira 2002), a weighted
  least-squares fit of ``z(r) = d sqrt(r) + c / sqrt(r)`` to the normal
  quantiles of the win proportions at several resampling scales r,
  ``p_au = 1 - Phi(d - c)``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from trex_tpu_torch.ops.likelihood import _f32
from trex_tpu_torch.search import bootstrap as _bootstrap
from trex_tpu_torch.search.alrt import rell_totals
from trex_tpu_torch.topology import Topology

AU_SCALES = (0.5, 0.6, 0.7, 0.8, 0.9, 1.0, 1.1, 1.2, 1.3, 1.4)


@dataclass
class TopologyTestResult:
    """Per-tree test results, aligned with the input tree order."""

    log_likelihoods: np.ndarray  # (T,) observed lnL at Newton lengths
    delta: np.ndarray            # (T,) lnL_best - lnL_tree (0 for the best)
    p_kh: np.ndarray             # (T,) KH p-value vs the best tree
    p_sh: np.ndarray             # (T,) SH p-value (max-corrected)
    bp: np.ndarray               # (T,) RELL bootstrap proportion
    elw: np.ndarray              # (T,) expected likelihood weight
    best_index: int
    per_site: np.ndarray         # (T, P) per-pattern lnL vectors
    p_au: np.ndarray | None = None  # (T,) AU p-values (when au_scales set)


def au_replicate_weights(weights, n_replicates: int, scales, generator: torch.Generator,
                         device=None):
    """Per scale r, (R, P) float32 counts of ``round(total * r)`` patterns
    drawn with replacement, each with probability proportional to its
    weight (the AU test's multiscale resamples): uniform float64 draws
    from ``generator`` (so every device gets the same counts), turned into
    patterns by the inverse of the cumulative weights on ``device``
    (default the generator's)."""
    device = generator.device if device is None else torch.device(device)
    base = torch.as_tensor(weights).to(device=device, dtype=torch.float64)
    cdf = torch.cumsum(base / base.sum(), dim=0)
    length = base.shape[0]
    total = float(base.sum())
    out = []
    for r in scales:
        n_r = max(1, int(round(total * r)))
        u = torch.rand((n_replicates, n_r), generator=generator, dtype=torch.float64,
                       device=generator.device).to(device)
        # The first pattern whose cumulative weight exceeds u (a pattern of
        # weight 0 is never drawn); clamped against rounding at the top.
        picks = torch.searchsorted(cdf, u, right=True).clamp_(max=length - 1)
        counts = torch.zeros((n_replicates, length), dtype=torch.float32, device=device)
        out.append(counts.scatter_add_(1, picks, torch.ones_like(picks, dtype=torch.float32)))
    return out


def topology_tests(
    trees: Topology,
    leaf_sequences,
    n_states: int,
    *,
    rates=None,
    freqs=None,
    site_weights=None,
    n_replicates: int = 10000,
    n_sweeps: int = 8,
    sequences_are_masks: bool = False,
    au_scales: tuple[float, ...] | None = AU_SCALES,
    replicate_weights=None,
    au_weights=None,
    generator: torch.Generator | None = None,
    timings: dict | None = None,
    mesh=None,
) -> TopologyTestResult:
    """KH / SH / BP / ELW (and AU with ``au_scales``) over a batched
    Topology of candidate trees, on the device of ``leaf_sequences``.

    ``site_weights`` makes compressed patterns exact (the resamples draw
    patterns by their counts). The draws: ``replicate_weights`` ((R, P)
    counts) and ``au_weights`` (one (R, P) count matrix a scale), e.g. the
    JAX package's, or else from ``generator``: the replicates first
    (``search.bootstrap._replicate_weights``), then the AU scales
    (``au_replicate_weights``). ``timings`` gains the seconds of the fit
    ("fit"; ``per_site_matrix``'s keys under "per_site") and of the tests
    ("tests"). ``mesh``: an optional ('tree', 'site') ``parallel.mesh.Mesh``
    (every rank calls with the same inputs; None: this device alone): the
    fit's candidates split over ``tree``
    (``parallel.sharded.sharded_per_site_matrix``).
    """
    import time

    from trex_tpu_torch.parallel.sharded import sharded_per_site_matrix

    n_trees = int(trees.children.shape[0])
    if n_trees < 2:
        raise ValueError("topology tests need at least two candidate trees")
    leaves = torch.as_tensor(leaf_sequences)
    device = leaves.device
    length = leaves.shape[-1]
    weights = (torch.ones((length,), dtype=torch.float32, device=device) if site_weights is None
               else _f32(site_weights, device=device))
    clock = time.perf_counter()
    fit_timings: dict = {}
    per_site = sharded_per_site_matrix(
        mesh, trees, leaves, n_states, rates=rates, freqs=freqs, weights=weights,
        n_sweeps=n_sweeps, sequences_are_masks=sequences_are_masks, timings=fit_timings)
    obs = rell_totals(weights[None], per_site)[0].cpu().numpy().astype(np.float64)
    now = time.perf_counter()
    if timings is not None:
        timings.update(fit=now - clock, per_site=fit_timings)
    clock = now
    best = int(obs.argmax())
    delta = obs[best] - obs

    if replicate_weights is None:
        if generator is None:
            raise ValueError("topology_tests needs replicate_weights or a generator")
        replicate_weights = _bootstrap._replicate_weights(length, n_replicates, weights,
                                                          generator)
    rep_w = torch.as_tensor(replicate_weights).to(device=device, dtype=torch.float32)
    rell = rell_totals(rep_w, per_site).cpu().numpy().astype(np.float64)  # (R, T)

    # Centre each tree's replicate totals at its observed total: the shared
    # null hypothesis that all candidates explain the data equally well.
    centered = rell - obs[None, :] + 0.0
    centered = centered - centered.mean(axis=0, keepdims=True)
    p_kh = np.ones((n_trees,))
    p_sh = np.ones((n_trees,))
    for t in range(n_trees):
        if t == best:
            continue
        null_delta = centered[:, best] - centered[:, t]
        p_kh[t] = float(np.mean(null_delta >= delta[t]))
        null_max = centered.max(axis=1) - centered[:, t]
        p_sh[t] = float(np.mean(null_max >= delta[t]))
    winners = rell.argmax(axis=1)
    bp = np.bincount(winners, minlength=n_trees) / float(rell.shape[0])

    p_au = None
    if au_scales is not None and len(au_scales) >= 2:
        if au_weights is None:
            if generator is None:
                raise ValueError("the AU test needs au_weights or a generator")
            au_weights = au_replicate_weights(weights, n_replicates, au_scales, generator,
                                              device=device)
        p_au = _au_test(per_site, au_weights, n_replicates, au_scales)
    # ELW in log space: the softmax of replicate totals across trees.
    shifted = rell - rell.max(axis=1, keepdims=True)
    w = np.exp(shifted)
    w = w / w.sum(axis=1, keepdims=True)
    elw = w.mean(axis=0)
    if timings is not None:
        timings["tests"] = time.perf_counter() - clock
    return TopologyTestResult(
        log_likelihoods=obs, delta=delta, p_kh=p_kh, p_sh=p_sh, bp=bp, elw=elw,
        best_index=best, per_site=per_site.cpu().numpy().astype(np.float64), p_au=p_au,
    )


def _au_test(per_site: torch.Tensor, au_weights, n_replicates: int,
             scales: tuple[float, ...]) -> np.ndarray:
    """AU p-values from multiscale RELL bootstraps: each scale's (R, P)
    counts give each tree's win proportion bp_r; a weighted least-squares
    fit of ``Phi^{-1}(1 - bp_r) = d sqrt(r) + c / sqrt(r)`` (weights: the
    binomial delta-method precision of each quantile) gives the signed
    distance d and curvature c; ``p_au = 1 - Phi(d - c)``."""
    from scipy.stats import norm

    n_trees = per_site.shape[0]
    bps = np.zeros((len(scales), n_trees))
    for s_idx, counts in enumerate(au_weights):
        rep_w = torch.as_tensor(counts).to(device=per_site.device, dtype=torch.float32)
        wins = rell_totals(rep_w, per_site).argmax(dim=1).cpu().numpy()
        bps[s_idx] = np.bincount(wins, minlength=n_trees) / float(n_replicates)

    rs = np.asarray(scales, np.float64)
    p_au = np.zeros((n_trees,))
    for t in range(n_trees):
        bp_t = bps[:, t]
        usable = (bp_t > 0) & (bp_t < 1)
        if usable.sum() < 2:
            p_au[t] = 1.0 if bp_t.mean() > 0.5 else 0.0
            continue
        z = norm.ppf(1.0 - bp_t[usable])
        x1 = np.sqrt(rs[usable])
        x2 = 1.0 / np.sqrt(rs[usable])
        var = bp_t[usable] * (1.0 - bp_t[usable]) / n_replicates
        w = norm.pdf(z) ** 2 / np.maximum(var, 1e-12)
        design = np.stack([x1, x2], axis=1)
        sw = np.sqrt(w)
        beta, *_ = np.linalg.lstsq(sw[:, None] * design, sw * z, rcond=None)
        d, c = beta
        p_au[t] = float(1.0 - norm.cdf(d - c))
    return p_au
