"""The Bayesian commands of ``trex_tpu/cli/bayes.py``: ``mcmc`` (MC^3 tree
sampling, ``search.mcmc``), ``bayesfactor`` (stepping-stone marginal
likelihoods, ``search.marginal``), ``date`` (the clock test and node-age
dating, ``ops.clock`` and ``search.dating``), each on the card (``--device
cuda``, default) or the CPU, and ``concord`` (gene and site concordance
factors, ``search.concordance``, host numpy; the sCF quartets drawn by
``np.random.default_rng(--seed)``, as the JAX command draws them).

The samplers' start states come from ``np.random.default_rng(--seed)`` as
the JAX commands' do for ``PRNGKey(--seed)`` (``bayesfactor``: ``--seed``
plus the model's index), so they are the JAX start trees and lengths; the
chains' draws come from a ``torch.Generator`` on the device seeded the
same way (``search.mcmc.default_draws``), so they match JAX's in
distribution only. Non-jc models are fitted by ML (``optimize_model``) on
the NJ start tree (``mcmc``) or the given tree (``date``, ``bayesfactor``
for +g) and held fixed, as the JAX commands do.

``mcmc`` and ``bayesfactor`` take ``--mesh`` and join a launcher's world
(``torchrun --nproc-per-node N``), as the JAX commands take ``--mesh``:
the chains (``mcmc``: runs x chains) or the rungs split over the mesh's
'tree' axis (``--mesh auto`` and no flag in a world: the largest that
divides them), every rank runs the command, and only rank 0 prints and
writes files. The JSON is the single-process run's.
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch

from trex_tpu_torch._device import resolve_device
from trex_tpu_torch.cli._common import (
    _join_world,
    _load_alignment,
    _outgroup_indices,
    lowest_states,
)
from trex_tpu_torch.cli.trees import _read_trees
from trex_tpu_torch.parallel.mesh import is_output_rank


def _patterns(args, device):
    """(names, masks, n_states, patterns (n, P) int32 and weights (P,) f32
    on ``device``) of ``--fasta``."""
    from trex_tpu_torch.alignment import compress_alignment

    names, masks, n_states = _load_alignment(args.fasta, args.alphabet)
    patterns, weights = compress_alignment(masks)
    return (names, masks, n_states,
            torch.as_tensor(np.asarray(patterns, dtype=np.int32), device=device),
            torch.as_tensor(np.asarray(weights, dtype=np.float32), device=device))


def _tree_on(args, names, device):
    """``--tree`` with its leaves in the alignment's row order."""
    from trex_tpu_torch.io import align_leaf_order, load_newick

    with open(args.tree) as fh:
        topo, _, tree_names = load_newick(fh.read())
    if sorted(tree_names) != sorted(names):
        raise SystemExit("tree and alignment taxa differ")
    return align_leaf_order(topo, tree_names, names).to(device)


def run_mcmc(args, timings: dict | None = None) -> dict:
    """The printed JSON object of ``mcmc`` (rank 0 writes ``--output-tree``,
    ``--samples-out`` and ``--trace-out``). ``timings``: a dict that, when
    given, receives the sampler's wall seconds (``mcmc_sample``'s)."""
    from trex_tpu_torch.io import save_newick
    from trex_tpu_torch.search.mcmc import mcmc_sample
    from trex_tpu_torch.topology import from_numpy

    mesh = _join_world(args, divides=args.runs * args.chains)
    device = resolve_device(args.device)
    names, masks, n_states, patterns, weights = _patterns(args, device)
    out: dict[str, object] = {
        "n_taxa": len(names),
        "n_sites": int(masks.shape[1]),
        "unique_patterns": int((weights > 0).sum()),
        "generations": args.generations,
        "runs": args.runs,
        "chains": args.chains,
        "proposal": args.proposal,
        "model": args.model,
    }
    rates = freqs = gamma_shape = None
    if args.full_bayes and args.model == "jc":
        # Full Bayes samples a GTR parameterization; an ML fit seeds it.
        args.model = "gtr"
        out["model"] = "gtr (full Bayes)"
    if args.model != "jc":
        if "+i" in args.model or "+r" in args.model:
            raise SystemExit("mcmc supports jc / gtr-family models with optional +g "
                             "(fit empirical-Bayes); +i and +rK are not supported")
        from trex_tpu_torch.ops import likelihood
        from trex_tpu_torch.search.nj import nj_start_tree

        ints = torch.as_tensor(lowest_states(patterns.cpu().numpy(), n_states), device=device)
        topo0, _ = nj_start_tree(ints, n_states, weights, device=device)
        params, _ = likelihood.optimize_model(
            topo0, patterns, n_states, model=args.model, sequences_are_masks=True,
            site_weights=weights)
        if "rates" in params:
            rates, freqs = params["rates"], params["freqs"]
        if "gamma_shape" in params:
            gamma_shape = float(params["gamma_shape"])
            out["gamma_shape"] = round(gamma_shape, 4)
        out["model_fit"] = ("ML on NJ start tree, chain seed (sampled during MCMC)"
                            if args.full_bayes else "ML on NJ start tree, fixed during MCMC")
    res = mcmc_sample(
        patterns, n_states, seed=args.seed, device=device, mesh=mesh,
        n_generations=args.generations, n_runs=args.runs, n_chains=args.chains,
        heat=args.heat, sample_every=args.sample_every, burnin_frac=args.burnin,
        branch_moves_per_gen=args.branch_moves, topo_proposal=args.proposal,
        topo_informed_power=args.informed_power, brlen_prior_mean=args.brlen_prior_mean,
        site_weights=weights, sequences_are_masks=True, rates=rates, freqs=freqs,
        gamma_shape=gamma_shape, sample_model=args.full_bayes, leaf_names=names,
        progress_every=args.progress_every, checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every, stop_after_generations=args.stop_after,
        timings=timings,
    )
    if args.full_bayes and res.sample_freqs is not None:
        out["posterior_freqs"] = [round(float(x), 4) for x in res.sample_freqs.mean(0)]
        out["posterior_rates"] = [round(float(x), 4) for x in res.sample_rates.mean(0)]
    # Samples are rooted on leaf 0, so clades of n_taxa - 1 leaves are the
    # always-present root split: trivial, skipped.
    split_names = sorted(
        ((p, sorted(names[i] for i in s)) for s, p in res.split_posterior.items()
         if 1 < len(s) < len(names) - 1),
        key=lambda t: -t[0],
    )
    out.update(
        n_samples=int(res.sample_lnl.size),
        mean_lnl=round(float(res.sample_lnl.mean()), 4) if res.sample_lnl.size else None,
        acceptance={k: round(v, 4) for k, v in res.acceptance.items()},
        asdsf=None if res.asdsf is None else round(res.asdsf, 4),
        ess_lnl=round(res.ess_lnl, 1),
        consensus_tree=res.consensus_newick,
        top_splits=[{"posterior": round(float(p), 3), "clade": c} for p, c in split_names[:10]],
    )
    if not is_output_rank():
        return out
    if args.output_tree:
        with open(args.output_tree, "w") as fh:
            fh.write(res.consensus_newick + "\n")
    if args.samples_out:
        zero = np.zeros((2 * len(names) - 1,), np.int32)
        with open(args.samples_out, "w") as fh:
            for c, lens in zip(res.sample_children, res.sample_lengths):
                fh.write(save_newick(from_numpy(c, zero), names, branch_lengths=lens) + "\n")
    if args.trace_out:
        # Tracer-compatible tab-separated log: state index and scalar traces.
        with open(args.trace_out, "w") as fh:
            cols = ["state", "lnL", "tree_length"]
            if res.sample_freqs is not None:
                cols += [f"freq{i}" for i in range(res.sample_freqs.shape[1])]
                cols += [f"rate{i}" for i in range(res.sample_rates.shape[1])]
            fh.write("\t".join(cols) + "\n")
            tl = res.sample_lengths[:, :-1].sum(axis=1)
            for i in range(res.sample_lnl.size):
                row = [str(i), f"{res.sample_lnl[i]:.6f}", f"{tl[i]:.6f}"]
                if res.sample_freqs is not None:
                    row += [f"{x:.6f}" for x in res.sample_freqs[i]]
                    row += [f"{x:.6f}" for x in res.sample_rates[i]]
                fh.write("\t".join(row) + "\n")
    return out


def cmd_mcmc(args) -> None:
    out = run_mcmc(args)
    if is_output_rank():
        print(json.dumps(out))


def run_bayesfactor(args, timings: dict | None = None) -> dict:
    """The printed JSON object of ``bayesfactor``: stepping-stone log
    marginal likelihoods of each ``--models`` entry on ``--tree`` ("jc"
    fixed; "gtr" integrates its simplices; "+g" at an ML-fitted shape).
    ``timings``: a dict that, when given, maps each model to its
    ``stepping_stone`` wall seconds."""
    from trex_tpu_torch.ops import likelihood
    from trex_tpu_torch.search.marginal import stepping_stone

    mesh = _join_world(args, divides=args.rungs)
    device = resolve_device(args.device)
    names, masks, n_states, patterns, weights = _patterns(args, device)
    topo = _tree_on(args, names, device)
    results = {}
    for i, model in enumerate(m.strip() for m in args.models.split(",")):
        gamma_shape = None
        base = model
        if model.endswith("+g"):
            base = model[:-2]
            params, _ = likelihood.optimize_model(
                topo, patterns, n_states, model=("gtr+g" if base == "gtr" else "jc+g"),
                sequences_are_masks=True, site_weights=weights)
            gamma_shape = float(params["gamma_shape"])
        if base not in ("jc", "gtr"):
            raise SystemExit(f"unsupported model {model!r} (jc/gtr[+g])")
        res = stepping_stone(
            topo, patterns, n_states, seed=args.seed + i, device=device, mesh=mesh,
            n_rungs=args.rungs, n_generations=args.generations, sample_model=base == "gtr",
            gamma_shape=gamma_shape, site_weights=weights, sequences_are_masks=True,
            timings=None if timings is None else timings.setdefault(model, {}))
        results[model] = {
            "log_marginal": round(res["log_marginal"], 4),
            "ess_min": round(res["ess_min"], 1),
            "acceptance": round(res["acceptance"], 3),
        }
        if gamma_shape is not None:
            results[model]["gamma_shape"] = round(gamma_shape, 4)
    best = max(results, key=lambda m: results[m]["log_marginal"])
    return {
        "n_taxa": len(names),
        "n_sites": int(masks.shape[1]),
        "rungs": args.rungs,
        "models": results,
        "best": best,
        "log_bayes_factors_vs_best": {
            m: round(results[m]["log_marginal"] - results[best]["log_marginal"], 4)
            for m in results
        },
    }


def cmd_bayesfactor(args) -> None:
    out = run_bayesfactor(args)
    if is_output_rank():
        print(json.dumps(out))


def run_date(args, timings: dict | None = None, clock_iterations: int | None = None) -> dict:
    """The printed JSON object of ``date``: the strict-clock LRT and
    Bayesian node ages of ``--tree`` (writes ``--output-tree``).
    ``timings``: a dict that, when given, receives the wall seconds of the
    clock test ("clock_lrt") and of ``mcmc_date``'s parts ("start_fit",
    "sampler"). ``clock_iterations``: the Adam steps of the test's and the
    start's clock fits (default: ``clock_lrt``'s and ``mcmc_date``'s)."""
    from trex_tpu_torch.ops import likelihood
    from trex_tpu_torch.ops.clock import clock_lrt
    from trex_tpu_torch.search.dating import mcmc_date

    device = resolve_device(args.device)
    names, masks, n_states, patterns, weights = _patterns(args, device)
    topo = _tree_on(args, names, device)
    rates = freqs = gamma_shape = None
    if args.model != "jc":
        params, _ = likelihood.optimize_model(
            topo, patterns, n_states, model=args.model, sequences_are_masks=True,
            site_weights=weights)
        if "rates" in params:
            rates, freqs = params["rates"], params["freqs"]
        if "gamma_shape" in params:
            gamma_shape = float(params["gamma_shape"])
    steps = {} if clock_iterations is None else {"n_iterations": clock_iterations}
    clock = time.perf_counter()
    lrt = clock_lrt(topo, patterns, n_states, sequences_are_masks=True, site_weights=weights,
                    rates=rates, freqs=freqs, **steps)
    if timings is not None:
        timings["clock_lrt"] = time.perf_counter() - clock
    tip_ages = None
    if args.tip_ages:
        tip_map = {}
        for pair in args.tip_ages.split(","):
            name_, _, age_s = pair.rpartition("=")
            if not name_ or name_ not in names:
                raise SystemExit(f"--tip-ages entry {pair!r}: want 'taxon=age' with a taxon "
                                 "from the alignment")
            tip_map[name_] = float(age_s)
        missing = [n for n in names if n not in tip_map]
        if missing:
            raise SystemExit(f"--tip-ages missing taxa: {missing[:5]}")
        tip_ages = np.array([tip_map[n] for n in names], np.float32)
    calibrations = None
    if args.calibrate:
        calibrations = {}
        for spec in args.calibrate:
            parts = spec.rsplit(":", 2)
            if len(parts) != 3:
                raise SystemExit(f"--calibrate wants 'taxa:min:max' or 'root:min:max', "
                                 f"got {spec!r}")
            who, lo_s, hi_s = parts
            key_ = ("root" if who.strip() == "root"
                    else frozenset(_outgroup_indices(names, who)))
            calibrations[key_] = (float(lo_s), float(hi_s))
    res = mcmc_date(
        topo, patterns, n_states, seed=args.seed, device=device,
        n_generations=args.generations, n_chains=args.chains,
        root_age_prior_mean=args.root_prior_mean, clock=args.clock,
        relaxed_sd=args.relaxed_sd, calibrations=calibrations, tip_ages=tip_ages,
        tree_prior=args.tree_prior, ne=args.ne, rates=rates, freqs=freqs,
        gamma_shape=gamma_shape, site_weights=weights, sequences_are_masks=True,
        leaf_names=names, timings=timings,
        **({} if clock_iterations is None else {"clock_fit_iterations": clock_iterations}),
    )
    n_leaves = len(names)
    out = {
        "n_taxa": n_leaves,
        "n_sites": int(masks.shape[1]),
        "model": args.model,
        "clock": args.clock,
        "clock_lrt": {"statistic": round(lrt["statistic"], 3), "df": lrt["df"],
                      "p_value": lrt["p_value"]},
        "generations": args.generations,
        "acceptance": {k: round(v, 4) for k, v in res.acceptance.items()},
        "ess_root_age": round(res.ess_root_age, 1),
        "root_age": {"mean": round(float(res.mean_ages[-1]), 5),
                     "hpd95": [round(float(x), 5) for x in res.age_hpd[-1]]},
        "node_ages": [
            {"ancestor": a, "mean": round(float(res.mean_ages[n_leaves + a]), 5),
             "hpd95": [round(float(x), 5) for x in res.age_hpd[n_leaves + a]]}
            for a in range(n_leaves - 1)
        ],
        "tree": res.newick,
    }
    if res.sample_rates is not None:
        out["branch_rates"] = [round(float(r), 4) for r in res.sample_rates.mean(0)[:-1]]
    if res.sample_clock_rate is not None:
        cr = res.sample_clock_rate
        out["clock_rate"] = {"mean": round(float(cr.mean()), 6),
                             "hpd95": [round(float(np.percentile(cr, 2.5)), 6),
                                       round(float(np.percentile(cr, 97.5)), 6)]}
        out["time_units"] = "calibrated (absolute)"
    if res.sample_ne is not None:
        ne_s = res.sample_ne
        out["coalescent_ne"] = {"mean": round(float(ne_s.mean()), 6),
                                "hpd95": [round(float(np.percentile(ne_s, 2.5)), 6),
                                          round(float(np.percentile(ne_s, 97.5)), 6)]}
    if args.output_tree:
        with open(args.output_tree, "w") as fh:
            fh.write(res.newick + "\n")
    return out


def cmd_date(args) -> None:
    print(json.dumps(run_date(args)))


def run_concord(args) -> dict:
    """The printed JSON object of ``concord``."""
    from trex_tpu_torch.io import load_newick, renumber_leaves, save_newick
    from trex_tpu_torch.search.concordance import concordance_factors

    with open(args.tree) as fh:
        ref, _, names = load_newick(fh.read())
    order = {n: i for i, n in enumerate(names)}
    gene_trees = None
    if args.gene_trees:
        gene_trees = []
        for chunk in _read_trees(args.gene_trees):
            topo, _, gnames = load_newick(chunk)
            if sorted(gnames) != sorted(names):
                raise SystemExit("gene trees must cover the same taxa")
            gene_trees.append(renumber_leaves(topo, [order[n] for n in gnames]))
    masks = None
    if args.fasta:
        anames, masks, _ = _load_alignment(args.fasta, args.alphabet)
        if sorted(anames) != sorted(names):
            raise SystemExit("alignment and tree taxa differ")
        masks = masks[[anames.index(n) for n in names]]
    if gene_trees is None and masks is None:
        raise SystemExit("need --gene-trees (gCF) and/or --fasta (sCF)")
    res = concordance_factors(
        ref, gene_trees=gene_trees, leaf_sequences=masks, n_quartets=args.quartets,
        seed=args.seed, sequences_are_masks=masks is not None,
    )

    def fmt(x):
        return None if x is None or np.isnan(x) else round(float(x) * 100, 1)

    labels = []
    per_branch = []
    for a in range(ref.n_leaves - 1):
        g = fmt(res.gcf[a]) if res.gcf is not None else None
        s = fmt(res.scf[a]) if res.scf is not None else None
        per_branch.append({"ancestor": a, "gcf": g, "scf": s})
        labels.append("/".join(str(v) for v in (g, s) if v is not None))
    out = {
        "n_taxa": len(names),
        "n_gene_trees": len(gene_trees) if gene_trees else 0,
        "quartets": args.quartets if masks is not None else 0,
        "branches": per_branch,
        "tree": save_newick(ref, names, support=labels),
    }
    if args.output_tree:
        with open(args.output_tree, "w") as fh:
            fh.write(out["tree"] + "\n")
    return out


def cmd_concord(args) -> None:
    print(json.dumps(run_concord(args)))
