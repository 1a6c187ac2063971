"""Stepping-stone marginal likelihood for Bayes factors (counterpart of
``trex_tpu/search/marginal.py``; Xie et al. 2011, Syst. Biol. 60:150).

Power posteriors prior x likelihood^beta_k along the ladder beta_k =
(k / K)^(1 / alpha) run as the rows of one chain batch on a fixed
topology; each ratio Z(beta_{k+1}) / Z(beta_k) is the rung's mean of
L^(beta_{k+1} - beta_k), and the log marginal likelihood their log sum.
Moves: branch-length multipliers and, with ``sample_model``, Dirichlet
moves on each rung's GTR simplices (flat priors, unheated). Every step's
likelihood is one K4 call on the K rungs' copies of the topology
(``search.mcmc._build_eval``); the steps run with no host sync and the
lnL trace comes back once.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from trex_tpu_torch.topology import Topology


def stepping_stone(
    topology: Topology,
    leaf_sequences,
    n_states: int,
    *,
    seed: int = 0,
    draws=None,
    device=None,
    mesh=None,
    n_rungs: int = 32,
    n_generations: int = 3000,
    burnin_frac: float = 0.3,
    alpha: float = 0.3,
    brlen_prior_mean: float = 0.1,
    tuning: float = 1.4,
    moves_per_generation: int = 2,
    rates=None,
    freqs=None,
    gamma_shape: float | None = None,
    n_categories: int = 4,
    sample_model: bool = False,
    model_tuning: float = 200.0,
    site_weights=None,
    sequences_are_masks: bool = False,
    timings: dict | None = None,
) -> dict:
    """Log marginal likelihood of (model, ``topology``) (the reference's
    arguments; ``seed`` seeds the numpy start state and, without
    ``draws``, the run's generator; ``device`` defaults to the leaves'
    when they are a tensor, else ``cuda``). ``sample_model`` integrates
    the GTR simplices over their priors; fixed ``rates``/``freqs`` give the
    marginal conditional on them.

    Returns ``log_marginal``, the per-rung ``log_ratios``, ``betas``,
    ``acceptance`` (of the branch moves) and ``ess_min`` (the worst
    rung's ESS of its power term). ``timings``: a dict that, when given,
    receives the wall seconds of the generations ("sampler": the start
    state on the device to the trace on the host).

    ``mesh``: a ('tree', 'site') ``parallel.mesh.Mesh`` (None: this rank
    alone) whose ``tree`` axis splits the rungs, which it must divide.
    Every rank draws each draw of the whole ladder (a Dirichlet move
    gathers the rungs' concentrations first) and takes its rows; the
    accepts are summed over ``tree`` and the trace gathered once, at the
    end, so every rank returns the single-device result.
    """
    from trex_tpu_torch._device import resolve_device
    from trex_tpu_torch.parallel.chains import chain_rows, gather_rows, psum_counts
    from trex_tpu_torch.parallel.mesh import local_mesh
    from trex_tpu_torch.search import mcmc
    from trex_tpu_torch.search.mcmc import (
        _build_eval,
        _dirichlet_logpdf,
        default_draws,
        effective_sample_size,
    )

    if device is None:
        device = leaf_sequences.device if torch.is_tensor(leaf_sequences) else "cuda"
    device = resolve_device(device)
    mesh = mesh or local_mesh()
    mine = chain_rows(mesh, n_rungs, "n_rungs")
    n_local = mine.stop - mine.start
    if draws is None:
        draws = default_draws(seed, device)
    topology = topology.to(device)
    n_all = topology.n_all
    q = n_states
    prior_rate = 1.0 / brlen_prior_mean
    leaves = torch.as_tensor(np.asarray(leaf_sequences.cpu() if torch.is_tensor(leaf_sequences)
                                        else leaf_sequences), device=device).to(torch.int32)
    weights = None if site_weights is None else torch.as_tensor(
        np.asarray(site_weights.cpu() if torch.is_tensor(site_weights) else site_weights),
        dtype=torch.float32, device=device)
    batched_eval, _ = _build_eval(leaves, n_states, weights, sequences_are_masks, rates, freqs,
                                  gamma_shape, n_categories, sample_model)
    rung_children = topology.children[None].expand(n_local, -1, -1).contiguous()

    def ev(lengths, rates_v, freqs_v):
        if sample_model:
            return batched_eval(rung_children, lengths, rates_v, freqs_v)
        return batched_eval(rung_children, lengths)

    k = np.arange(n_rungs)
    betas = (k / n_rungs) ** (1.0 / alpha)
    betas_up = ((k + 1) / n_rungs) ** (1.0 / alpha)
    beta = torch.as_tensor(betas.astype(np.float32)[mine], device=device)

    rng = np.random.default_rng(int(seed))
    lengths0 = rng.exponential(brlen_prior_mean, size=(n_rungs, n_all)).astype(np.float32)
    lengths0[:, -1] = 0.0
    n_pairs = q * (q - 1) // 2
    rates0 = rng.dirichlet(np.ones(n_pairs), size=n_rungs).astype(np.float32)
    freqs0 = rng.dirichlet(np.ones(q), size=n_rungs).astype(np.float32)

    total_steps = n_generations * moves_per_generation
    clock = time.perf_counter()
    lengths = torch.as_tensor(lengths0[mine], device=device)
    rates_v = torch.as_tensor(rates0[mine], device=device)
    freqs_v = torch.as_tensor(freqs0[mine], device=device)
    lnl = ev(lengths, rates_v, freqs_v)
    rows = torch.arange(n_local, device=device)
    accepted = torch.zeros((), dtype=torch.int64, device=device)
    trace = torch.empty((total_steps, n_local), device=device)

    def simplex_move(x, lnl, evaluate):
        """Power-posterior Dirichlet-centred move on a simplex batch."""
        conc = model_tuning * x
        prop = draws.dirichlet(gather_rows(mesh, conc))[mine]
        lq_fwd = _dirichlet_logpdf(prop, conc)
        lq_rev = _dirichlet_logpdf(x, model_tuning * prop)
        inside = prop.amin(dim=-1) >= 1e-5
        # A proposal outside the truncated prior is rejected whatever its lnL; the
        # current simplex stands in for it, so no eigensystem sees a degenerate one.
        prop_lnl = evaluate(torch.where(inside[:, None], prop, x))
        log_alpha = beta * (prop_lnl - lnl) + lq_rev - lq_fwd
        take = inside & mcmc.metropolis_accept(draws.uniform((n_rungs,))[mine], log_alpha)
        return torch.where(take[:, None], prop, x), torch.where(take, prop_lnl, lnl)

    for step in range(total_steps):
        node = draws.randint((n_rungs,), 0, n_all - 1)[mine]
        factor = torch.exp(tuning * (draws.uniform((n_rungs,))[mine] - 0.5))
        old = lengths[rows, node]
        new = old * factor
        prop = lengths.scatter(1, node[:, None], new[:, None])
        prop_lnl = ev(prop, rates_v, freqs_v)
        # Power posterior: the prior unheated, the likelihood to the beta.
        log_alpha = beta * (prop_lnl - lnl) - prior_rate * (new - old) + torch.log(factor)
        take = mcmc.metropolis_accept(draws.uniform((n_rungs,))[mine], log_alpha)
        lengths = torch.where(take[:, None], prop, lengths)
        lnl = torch.where(take, prop_lnl, lnl)
        accepted += take.sum()
        if sample_model:
            rates_v, lnl = simplex_move(rates_v, lnl, lambda rv: ev(lengths, rv, freqs_v))
            freqs_v, lnl = simplex_move(freqs_v, lnl, lambda fv: ev(lengths, rates_v, fv))
        trace[step] = lnl

    trace = gather_rows(mesh, trace.T).T  # (total_steps, n_rungs)
    accepted = psum_counts(mesh, accepted)
    samples = trace.cpu().numpy()[int(burnin_frac * total_steps):]
    if timings is not None:
        timings["sampler"] = time.perf_counter() - clock
    # log r_k = log mean exp((beta_{k+1} - beta_k) lnL_k).
    terms = (betas_up - betas)[None, :] * samples
    m = terms.max(axis=0)
    log_ratios = m + np.log(np.exp(terms - m).mean(axis=0))
    ess = [effective_sample_size(terms[:, j]) for j in range(n_rungs)]
    return {
        "log_marginal": float(log_ratios.sum()),
        "log_ratios": log_ratios,
        "betas": betas,
        "acceptance": float(accepted.cpu()) / (total_steps * n_rungs),
        "ess_min": float(min(ess)),
    }
