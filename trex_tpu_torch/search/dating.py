"""Bayesian node-age dating on a fixed topology (counterpart of
``trex_tpu/search/dating.py``).

The state of each chain is its vector of node ages (leaves at age 0, or at
their sampling ages under tip dating), with a relaxed clock's per-branch
log-rates, a calibrated analysis's global log clock rate and a coalescent
prior's Ne. All chains are one device batch and the generations run as a
loop of tensor operations with no host sync; the traces come back once at
the end. Every likelihood is one K4 call on the chains' copies of the
topology (``search.mcmc._build_eval``).

Moves a generation, in the reference's order: the interior slide (uniform
between the higher child and the parent, inside any calibration window),
a relaxed clock's log-rate walk on one branch, the root multiplier (its
step adapted toward 40% acceptance during burn-in only), a calibrated or
tip-dated analysis's clock-rate walk and joint (ages x f, rate / f) scale
move, and the conjugate Gibbs draw of Ne, InvGamma(a0 + n - 1, b0 + A).
Priors: root age Exponential(1 / ``root_age_prior_mean``), interior ages
uniform given the root, or the (serial) Kingman coalescent; a relaxed
clock's rates LogNormal(-sd^2 / 2, sd^2); the clock rate LogNormal around
its ML-derived start.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from trex_tpu_torch.topology import Topology


@dataclasses.dataclass
class DatingResult:
    sample_ages: np.ndarray
    """(n_samples, n_all) posterior age samples (all chains pooled)."""
    sample_lnl: np.ndarray
    """(n_samples,) data log-likelihoods."""
    mean_ages: np.ndarray
    """(n_all,) posterior mean age per node."""
    age_hpd: np.ndarray
    """(n_all, 2) central 95% posterior interval per node."""
    ess_root_age: float
    acceptance: dict[str, float]
    newick: str
    """Ultrametric tree with the branch lengths of the posterior mean ages."""
    generations: int
    sample_rates: np.ndarray | None = None
    """(n_samples, n_all) relaxed-clock branch rate multipliers, or None."""
    sample_clock_rate: np.ndarray | None = None
    """(n_samples,) global substitution rate (calibrated analyses), or None."""
    sample_ne: np.ndarray | None = None
    """(n_samples,) coalescent Ne (sampled), or None."""


def coalescent_area(ages: torch.Tensor, n_leaves: int) -> torch.Tensor:
    """(...,) Kingman area A = sum over inter-event intervals of
    k (k - 1) / 2 dt of ages (..., n_all) (tips may be above 0); log p(ages
    | Ne) = -(n - 1) log Ne - A / Ne."""
    n_all = ages.shape[-1]
    idx = torch.arange(n_all, device=ages.device)
    deltas = torch.where(idx < n_leaves, 1.0, -1.0)
    order = torch.argsort(ages, dim=-1, stable=True)
    k = torch.cumsum(deltas[order], dim=-1)
    dt = torch.diff(ages.gather(-1, order), dim=-1)
    k_mid = k[..., :-1]
    return (k_mid * (k_mid - 1.0) / 2.0 * dt).sum(dim=-1)


def mcmc_date(
    topology: Topology,
    leaf_sequences,
    n_states: int,
    *,
    seed: int = 0,
    draws=None,
    device=None,
    mesh=None,
    n_generations: int = 4000,
    n_chains: int = 2,
    sample_every: int = 4,
    burnin_frac: float = 0.25,
    root_age_prior_mean: float = 0.3,
    root_tuning: float = 0.6,
    clock: str = "strict",
    relaxed_sd: float = 0.3,
    rate_tuning: float = 1.0,
    calibrations: dict | None = None,
    tip_ages: np.ndarray | None = None,
    clock_rate_prior_sd: float = 1.5,
    tree_prior: str = "uniform",
    ne: float | None = None,
    ne_prior: tuple[float, float] = (0.001, 0.001),
    start_ages: np.ndarray | None = None,
    rates=None,
    freqs=None,
    gamma_shape: float | None = None,
    n_categories: int = 4,
    site_weights=None,
    sequences_are_masks: bool = False,
    leaf_names: list[str] | None = None,
    prior_only: bool = False,
    clock_fit_iterations: int = 500,
    timings: dict | None = None,
) -> DatingResult:
    """Sample the node ages of ``topology`` under a strict or relaxed clock
    (the reference's arguments; ``seed`` and ``draws`` take the place of
    its key: ``seed`` seeds the numpy start state and, without ``draws``,
    the run's generator; ``device`` defaults to the leaves' when they are a
    tensor, else ``cuda``).

    ``n_chains`` independent chains, all sampled. ``start_ages`` defaults
    to the ML clock fit (``ops.clock.optimize_clock``), jittered a chain.
    ``calibrations`` maps clades (leaf-index sets, or "root") to uniform
    (min, max) bounds on their MRCA's age and samples a clock rate;
    ``tip_ages`` fixes the leaves at their sampling ages (tip dating).
    ``tree_prior="coalescent"`` replaces the uniform prior with Kingman's,
    Ne fixed at ``ne`` or Gibbs-sampled (``ne=None``).
    ``clock_fit_iterations``: the Adam steps of that clock fit.
    ``timings``: a dict that, when given, receives the wall seconds of the
    clock fit ("start_fit", when it runs) and of the generations
    ("sampler": the start state on the device to the traces on the host).

    ``mesh``: a ('tree', 'site') ``parallel.mesh.Mesh`` (None: this rank
    alone) whose ``tree`` axis splits the chains, which it must divide.
    The chains are independent: every rank runs the start fit and draws
    each draw of the whole batch, then takes its rows; the accept counts
    are summed over ``tree`` and the traces gathered once, at the end, so
    every rank returns the single-device result.
    """
    from trex_tpu_torch._device import resolve_device
    from trex_tpu_torch.io import save_newick
    from trex_tpu_torch.ops.clock import ages_to_lengths, increments_to_ages, optimize_clock
    from trex_tpu_torch.parallel.chains import chain_rows, gather_packed, psum_counts
    from trex_tpu_torch.parallel.mesh import local_mesh
    from trex_tpu_torch.search import mcmc
    from trex_tpu_torch.search.mcmc import (
        _build_eval,
        default_draws,
        effective_sample_size,
    )

    if device is None:
        device = leaf_sequences.device if torch.is_tensor(leaf_sequences) else "cuda"
    device = resolve_device(device)
    topology = topology.to(device)
    n_leaves, n_all, n_anc = topology.n_leaves, topology.n_all, topology.n_ancestors
    children_np = topology.children.cpu().numpy()
    parents = topology.parents.long()
    children = topology.children.long()
    prior_rate = 1.0 / root_age_prior_mean
    if clock not in ("strict", "relaxed"):
        raise ValueError(f"unknown clock {clock!r}")
    if tree_prior not in ("uniform", "coalescent"):
        raise ValueError(f"unknown tree_prior {tree_prior!r}")
    relaxed = clock == "relaxed"
    mesh = mesh or local_mesh()
    mine = chain_rows(mesh, n_chains, "n_chains")
    n_local = mine.stop - mine.start
    if draws is None:
        draws = default_draws(seed, device)

    leaves = torch.as_tensor(np.asarray(leaf_sequences.cpu() if torch.is_tensor(leaf_sequences)
                                        else leaf_sequences), device=device).to(torch.int32)
    weights = None if site_weights is None else torch.as_tensor(
        np.asarray(site_weights.cpu() if torch.is_tensor(site_weights) else site_weights),
        dtype=torch.float32, device=device)
    if prior_only:
        leaves = torch.zeros((n_leaves, 1), dtype=torch.int32, device=device)
        weights = torch.zeros((1,), device=device)
        sequences_are_masks = False

    # --- calibrations: per-node uniform age bounds and a sampled clock rate --
    heterochronous = tip_ages is not None and np.ptp(np.asarray(tip_ages)) > 0
    calibrated = bool(calibrations) or tip_ages is not None
    cal_lo = np.zeros(n_all, np.float32)
    cal_hi = np.full(n_all, np.inf, np.float32)
    if calibrations:
        from trex_tpu_torch.search.bootstrap import subtree_leaf_sets

        clade_to_node = {s: n_leaves + i for i, s in enumerate(subtree_leaf_sets(topology))}
        for clade, (lo_b, hi_b) in calibrations.items():
            if clade == "root":
                node = n_all - 1
            else:
                node = clade_to_node.get(frozenset(clade))
                if node is None:
                    raise ValueError(
                        f"calibrated clade {sorted(clade)} is not monophyletic in the topology")
            cal_lo[node] = lo_b
            cal_hi[node] = hi_b
    cal_lo_dev = torch.as_tensor(cal_lo, device=device)
    cal_hi_dev = torch.as_tensor(cal_hi, device=device)

    batched_eval, _ = _build_eval(leaves, n_states, weights, sequences_are_masks, rates, freqs,
                                  gamma_shape, n_categories, False)
    chain_children = topology.children[None].expand(n_local, -1, -1).contiguous()

    def lnl_of(ages, log_rates, log_cr):
        lengths = ages_to_lengths(topology, ages)
        if calibrated:
            lengths = lengths * torch.exp(log_cr)[:, None]
        if relaxed:
            lengths = lengths * torch.exp(log_rates)
        return batched_eval(chain_children, lengths)

    sd2 = relaxed_sd * relaxed_sd
    # A bounded calibrated root takes a uniform prior from its window.
    if calibrated and np.isfinite(cal_hi[-1]):
        prior_rate = 0.0
    coalescent = tree_prior == "coalescent"
    sample_ne = coalescent and ne is None
    ne0 = float(ne) if ne is not None else 1.0
    ne_a0, ne_b0 = ne_prior
    if coalescent:
        prior_rate = 0.0

    def dtree_logprior(prop_ages, ages, ne_batch):
        if not coalescent:
            return 0.0
        return -(coalescent_area(prop_ages, n_leaves) - coalescent_area(ages, n_leaves)) / ne_batch

    # --- initial ages (numpy, the reference's draws) --------------------------
    rng = np.random.default_rng(int(seed))
    log_clock_rate0 = 0.0
    if start_ages is None and not prior_only:
        clock_t0 = time.perf_counter()
        ml_ages, _ = optimize_clock(topology, leaves, n_states,
                                    sequences_are_masks=sequences_are_masks,
                                    site_weights=weights, rates=rates, freqs=freqs,
                                    n_iterations=clock_fit_iterations)
        start_ages = ml_ages.cpu().numpy()
        if timings is not None:
            timings["start_fit"] = time.perf_counter() - clock_t0
        if heterochronous:
            ml_root = max(float(start_ages[-1]), 1e-6)
            tips = np.asarray(tip_ages, np.float64)
            span = max(float(np.ptp(tips)), 1e-6)
            scale = 2.0 * span / ml_root
            start2 = np.zeros(n_all)
            start2[:n_leaves] = tips
            ml_np = np.asarray(start_ages, np.float64)
            for a in range(n_anc):
                v = n_leaves + a
                c0, c1 = int(children_np[a, 0]), int(children_np[a, 1])
                inc_ml = ml_np[v] - max(ml_np[c0], ml_np[c1])
                start2[v] = max(start2[c0], start2[c1]) + max(inc_ml, 1e-4) * scale
            start_ages = start2
            log_clock_rate0 = float(np.log(max(ml_root / (2.0 * span), 1e-8)))
        elif calibrated:
            cal_nodes = [v for v in range(n_all) if cal_lo[v] > 0 or np.isfinite(cal_hi[v])]
            anchor = cal_nodes[0]
            hi_eff = cal_hi[anchor] if np.isfinite(cal_hi[anchor]) else cal_lo[anchor] * 3.0 + 1.0
            target = (cal_lo[anchor] + hi_eff) / 2.0
            ml_anchor = max(float(start_ages[anchor]), 1e-6)
            start_ages = start_ages * (target / ml_anchor)
            log_clock_rate0 = float(np.log(max(ml_anchor / target, 1e-8)))
    elif start_ages is None:
        increments = torch.as_tensor(rng.uniform(0.02, 0.1, size=n_anc).astype(np.float32))
        start_ages = increments_to_ages(topology.to("cpu"), increments).numpy()
    ages0 = np.broadcast_to(np.asarray(start_ages, np.float32)[None], (n_chains, n_all)).copy()
    if tip_ages is not None:
        ages0[:, :n_leaves] = np.asarray(tip_ages, np.float32)[None]
    ages0[:, n_leaves:] *= rng.uniform(0.95, 1.05, size=(n_chains, n_anc)).astype(np.float32)
    for c in range(n_chains):
        for a in range(n_anc):
            v = n_leaves + a
            lo = max(float(ages0[c, int(children_np[a, 0])]),
                     float(ages0[c, int(children_np[a, 1])]), float(cal_lo[v]))
            if ages0[c, v] <= lo:
                ages0[c, v] = lo + 1e-4
            if ages0[c, v] > cal_hi[v]:
                ages0[c, v] = max(cal_hi[v] - 1e-4, lo + 1e-4)
    if calibrated:
        bad = [(c, v) for c in range(n_chains) for v in range(n_leaves, n_all)
               if not (cal_lo[v] <= ages0[c, v] <= cal_hi[v])]
        if bad:
            raise ValueError("could not satisfy all calibration windows jointly from the "
                             f"starting ages (violations: {bad[:4]}...)")
    log_rates0 = np.zeros((n_chains, n_all), np.float32)
    if relaxed:
        log_rates0[:, :-1] = rng.normal(-0.5 * sd2, relaxed_sd,
                                        size=(n_chains, n_all - 1)).astype(np.float32)
    log_cr0 = np.full((n_chains,), log_clock_rate0, np.float32)
    ne_init = np.full((n_chains,), ne0, np.float32)
    if sample_ne:
        a_start = coalescent_area(torch.as_tensor(ages0), n_leaves).numpy()
        ne_init = ((ne_b0 + a_start) / max(ne_a0 + (n_leaves - 1) - 1.0, 1.0)).astype(np.float32)

    # --- the generations: tensor operations on the chain batch ----------------
    n_burnin = int(burnin_frac * n_generations)
    put = lambda x: torch.as_tensor(x[mine], device=device)  # noqa: E731
    clock_t0 = time.perf_counter()
    ages, log_rates, log_cr, ne_vec = put(ages0), put(log_rates0), put(log_cr0), put(ne_init)
    lnl = lnl_of(ages, log_rates, log_cr)
    rows = torch.arange(n_local, device=device)
    acc = torch.zeros((4,), dtype=torch.int64, device=device)  # slide, root, rate, clock rate
    log_tune = torch.log(torch.full((n_local,), root_tuning, device=device))
    tune_lo = torch.log(torch.tensor(1e-3, device=device))
    tune_hi = torch.log(torch.tensor(4.0, device=device))
    root_kids = children[-1]
    tr_ages = torch.empty((n_generations, n_local, n_all), device=device)
    tr_rates = torch.empty_like(tr_ages)
    tr_cr = torch.empty((n_generations, n_local), device=device)
    tr_ne = torch.empty_like(tr_cr)
    tr_lnl = torch.empty_like(tr_cr)
    cr_var2 = 2.0 * clock_rate_prior_sd ** 2
    for step in range(n_generations):
        if n_anc > 1:
            node = n_leaves + draws.randint((n_chains,), 0, n_anc - 1)[mine]
            kid_pair = children[node - n_leaves]
            low = torch.maximum(
                torch.maximum(ages[rows, kid_pair[:, 0]], ages[rows, kid_pair[:, 1]]),
                cal_lo_dev[node])
            high = torch.minimum(ages[rows, parents[node]], cal_hi_dev[node])
            prop_age = low + (high - low) * draws.uniform((n_chains,))[mine]
            prop = ages.scatter(1, node[:, None], prop_age[:, None])
            prop_lnl = lnl_of(prop, log_rates, log_cr)
            take = mcmc.metropolis_accept(draws.uniform((n_chains,))[mine],
                                          prop_lnl - lnl + dtree_logprior(prop, ages, ne_vec))
            ages = torch.where(take[:, None], prop, ages)
            lnl = torch.where(take, prop_lnl, lnl)
            acc[0] += take.sum()
        if relaxed:
            rnode = draws.randint((n_chains,), 0, n_all - 1)[mine]
            step_lr = rate_tuning * relaxed_sd * draws.normal((n_chains,))[mine]
            old_lr = log_rates.gather(1, rnode[:, None])[:, 0]
            new_lr = old_lr + step_lr
            prop_lr = log_rates.scatter(1, rnode[:, None], new_lr[:, None])
            prop_lnl = lnl_of(ages, prop_lr, log_cr)
            mu = -0.5 * sd2
            dprior = ((old_lr - mu) ** 2 - (new_lr - mu) ** 2) / (2.0 * sd2)
            take = mcmc.metropolis_accept(draws.uniform((n_chains,))[mine],
                                          prop_lnl - lnl + dprior)
            log_rates = torch.where(take[:, None], prop_lr, log_rates)
            lnl = torch.where(take, prop_lnl, lnl)
            acc[2] += take.sum()
        # Root multiplier.
        factor = torch.exp(torch.exp(log_tune) * (draws.uniform((n_chains,))[mine] - 0.5))
        old_root = ages[:, -1]
        new_root = old_root * factor
        low = torch.maximum(torch.maximum(ages[:, root_kids[0]], ages[:, root_kids[1]]),
                            cal_lo_dev[-1])
        prop = torch.cat([ages[:, :-1], new_root[:, None]], dim=1)
        prop_lnl = lnl_of(prop, log_rates, log_cr)
        log_alpha = (prop_lnl - lnl - prior_rate * (new_root - old_root)
                     + dtree_logprior(prop, ages, ne_vec) + torch.log(factor))
        take = ((new_root > low) & (new_root <= cal_hi_dev[-1])
                & mcmc.metropolis_accept(draws.uniform((n_chains,))[mine], log_alpha))
        ages = torch.where(take[:, None], prop, ages)
        lnl = torch.where(take, prop_lnl, lnl)
        if step >= n_burnin:
            acc[1] += take.sum()
        adapting = 1.0 if step < n_burnin else 0.0
        log_tune = torch.clamp(log_tune + adapting * 0.08 * (take.float() - 0.4),
                               min=tune_lo, max=tune_hi)
        if calibrated:
            new_cr = log_cr + 0.3 * draws.normal((n_chains,))[mine]
            prop_lnl = lnl_of(ages, log_rates, new_cr)
            dprior = ((log_cr - log_clock_rate0) ** 2 - (new_cr - log_clock_rate0) ** 2) / cr_var2
            take = mcmc.metropolis_accept(draws.uniform((n_chains,))[mine],
                                          prop_lnl - lnl + dprior)
            log_cr = torch.where(take, new_cr, log_cr)
            lnl = torch.where(take, prop_lnl, lnl)
            acc[3] += take.sum()
            # The joint (ages x f, rate / f) move: the likelihood is invariant
            # (lengths = rate x dt) unless fixed tips break the invariance.
            f = torch.exp(0.5 * (draws.uniform((n_chains,))[mine] - 0.5))
            prop_ages = torch.cat([ages[:, :n_leaves], ages[:, n_leaves:] * f[:, None]], dim=1)
            new_cr2 = log_cr - torch.log(f)
            inside = ((prop_ages[:, n_leaves:] >= cal_lo_dev[None, n_leaves:])
                      & (prop_ages[:, n_leaves:] <= cal_hi_dev[None, n_leaves:])).all(dim=1)
            if heterochronous:
                kid_max = torch.maximum(prop_ages[:, children[:, 0]], prop_ages[:, children[:, 1]])
                inside = inside & (prop_ages[:, n_leaves:] > kid_max).all(dim=1)
            dprior = (-prior_rate * (prop_ages[:, -1] - ages[:, -1])
                      + ((log_cr - log_clock_rate0) ** 2 - (new_cr2 - log_clock_rate0) ** 2)
                      / cr_var2
                      + dtree_logprior(prop_ages, ages, ne_vec))
            if heterochronous:
                prop_lnl = lnl_of(prop_ages, log_rates, new_cr2)
                dlik = prop_lnl - lnl
            else:
                prop_lnl = lnl
                dlik = 0.0
            take = inside & mcmc.metropolis_accept(draws.uniform((n_chains,))[mine],
                                                   dlik + dprior + n_anc * torch.log(f))
            ages = torch.where(take[:, None], prop_ages, ages)
            log_cr = torch.where(take, new_cr2, log_cr)
            lnl = torch.where(take, prop_lnl, lnl)
        if sample_ne:
            area = coalescent_area(ages, n_leaves)
            ne_vec = (ne_b0 + area) / draws.gamma(ne_a0 + (n_leaves - 1), (n_chains,))[mine]
        tr_ages[step], tr_rates[step], tr_cr[step] = ages, log_rates, log_cr
        tr_ne[step], tr_lnl[step] = ne_vec, lnl

    # --- summaries (host): the chains' traces gathered over 'tree' -------------
    tr_ages, tr_rates, tr_cr, tr_ne, tr_lnl = (x.transpose(0, 1) for x in gather_packed(
        mesh, [x.transpose(0, 1) for x in (tr_ages, tr_rates, tr_cr, tr_ne, tr_lnl)]))
    trace_ages = tr_ages.cpu().numpy()
    acc_host = psum_counts(mesh, acc).cpu().numpy()
    if timings is not None:
        timings["sampler"] = time.perf_counter() - clock_t0
    keep = np.arange(n_burnin, n_generations, sample_every)
    sample_ages = trace_ages[keep].reshape(-1, n_all)
    sample_lnl = tr_lnl.cpu().numpy()[keep].reshape(-1)
    mean_ages = sample_ages.mean(axis=0)
    lo = np.percentile(sample_ages, 2.5, axis=0)
    hi = np.percentile(sample_ages, 97.5, axis=0)
    host_topology = topology.to("cpu")
    mean_lengths = ages_to_lengths(host_topology, torch.as_tensor(mean_ages.astype(np.float32)))
    newick = save_newick(host_topology, leaf_names,
                         branch_lengths=np.clip(mean_lengths.numpy(), 0, None))
    per_chain = max(n_generations * n_chains, 1)
    acceptance = {"slide": float(acc_host[0]) / per_chain,
                  "root": float(acc_host[1]) / max((n_generations - n_burnin) * n_chains, 1)}
    if relaxed:
        acceptance["rate"] = float(acc_host[2]) / per_chain
    if calibrated:
        acceptance["clock_rate"] = float(acc_host[3]) / per_chain
    return DatingResult(
        sample_ages=sample_ages,
        sample_lnl=sample_lnl,
        mean_ages=mean_ages,
        age_hpd=np.stack([lo, hi], axis=1),
        ess_root_age=effective_sample_size(trace_ages[n_burnin:, 0, -1]),
        acceptance=acceptance,
        newick=newick,
        generations=n_generations,
        sample_rates=(np.exp(tr_rates.cpu().numpy()[keep].reshape(-1, n_all))
                      if relaxed else None),
        sample_clock_rate=(np.exp(tr_cr.cpu().numpy()[keep].reshape(-1))
                           if calibrated else None),
        sample_ne=tr_ne.cpu().numpy()[keep].reshape(-1) if sample_ne else None,
    )
