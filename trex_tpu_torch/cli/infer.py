"""File-based tree inference: the ``infer`` command's parsimony, ML and
distance branches (counterpart of ``trex_tpu/cli/infer.py``)."""

from __future__ import annotations

import dataclasses
import json
import time

import torch

from trex_tpu_torch._device import resolve_device
from trex_tpu_torch.cli._common import (
    _join_world,
    _load_alignment,
    _outgroup_indices,
    _start_tree,
)
from trex_tpu_torch.parallel.mesh import is_output_rank
from trex_tpu_torch.search.hillclimb import (
    SearchResult,
    constrained_start,
    parsimony_hill_climb,
)
from trex_tpu_torch.search.ratchet import parsimony_ratchet

# Model and likelihood-support flags, which the JAX CLI ignores under
# parsimony and distance and this port refuses there (ROADMAP.md, accepted
# differences).
_MODEL_FLAGS = (("model", "jc"), ("model_file", None), ("model_rounds", 0), ("alrt", 0),
                ("ufboot", 0))


@dataclasses.dataclass
class InferRun:
    out: dict
    """The printed JSON object."""
    result: SearchResult | None
    """The search's result (None under ``--criterion distance``)."""
    seconds: dict
    """Wall seconds of the starting trees ("start"), the climbs or the
    ratchet ("climb"), the decay ("decay") and bootstrap ("bootstrap")
    when asked for, an enumerating climb's host generation ("generate")
    and batch scoring ("score"), and for ``--criterion ml`` the
    branch-length fits ("newton"), with ``--model`` the first model fit
    ("fit") and the model <-> tree rounds ("rounds"), with ``--ratchet``
    each reclimb ("reclimbs", a list), with ``--alrt`` and ``--ufboot``
    their walls ("alrt", "ufboot") and parts ("alrt_parts",
    "ufboot_parts": the functions' ``timings``). Under ``--criterion distance`` the
    distance tree ("start") and with ``--bootstrap`` the replicates'
    matrices ("distances") and their agglomeration ("agglomerate")."""
    lengths: torch.Tensor | None = None
    """The branch lengths (``--criterion ml``: fitted; distance: the NJ/UPGMA
    ones, clipped at 0)."""


def _check_ported(args) -> None:
    if args.criterion != "ml":
        for name, unset in _MODEL_FLAGS:
            if getattr(args, name) != unset:
                raise SystemExit(
                    f"--{name} applies to --criterion ml only (ROADMAP.md, accepted "
                    f"differences: the JAX CLI ignores it under {args.criterion})"
                )


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_infer(args) -> InferRun:
    """FASTA in, inferred tree out: start trees, then a parsimony (with the
    ratchet, constraints, rooting and supports) or (``--criterion ml``)
    likelihood climb (with the iterated search, constraints, rooting, a
    fitted model and bootstrap supports); or (``--criterion distance``)
    the NJ/UPGMA tree itself.

    With ``--mesh`` (or a launcher's world of more than one rank: every
    rank runs the command, ``torchrun --nproc-per-node N``) the climbs,
    scans, supports and bootstraps run across the ('tree', 'site') mesh
    where the JAX CLI's do, the JSON gains ``"mesh"``, and only rank 0
    writes ``--output-tree``."""
    import numpy as np

    from trex_tpu_torch.alignment import compress_alignment

    _check_ported(args)
    mesh = _join_world(args)
    device = resolve_device(args.device)
    names, masks, n_states = _load_alignment(args.fasta, args.alphabet)
    patterns, counts = compress_alignment(masks)
    patterns = np.asarray(patterns, dtype=np.int32)
    weights = torch.as_tensor(counts, dtype=torch.float32, device=device)

    out: dict[str, object] = {
        "criterion": args.criterion,
        "start": args.start,
        "n_taxa": len(names),
        "n_sites": int(masks.shape[1]),
        "unique_patterns": int((counts > 0).sum()),
    }
    if mesh is not None:
        out["mesh"] = dict(mesh.shape)
    if args.criterion == "distance":
        return _run_distance(args, out, names, patterns, n_states, weights)
    t0 = time.perf_counter()
    constraint = None
    if args.constraint:
        splits, taxa, ctopo, cids = _constraint(args, names, out)
        constraint = (splits, taxa)
        starts = [
            constrained_start(ctopo, cids, len(names), seed=args.seed + 1000 * r, device=device)
            for r in range(max(args.restarts, 1))
        ]
    else:
        # The --start tree, plus (--restarts - 1) more: random-addition-order
        # stepwise starts, or random trees when --start is not stepwise.
        extra = "stepwise" if args.start == "stepwise" else "random"
        starts = [
            _start_tree(
                args.start if r == 0 else extra, patterns, n_states,
                args.seed + 1000 * r, weights, args.orders, device,
            )
            for r in range(max(args.restarts, 1))
        ]
    _sync(device)
    t1 = time.perf_counter()
    if args.restarts > 1:
        out["restarts"] = args.restarts

    leaves = torch.as_tensor(patterns, device=device)
    if args.criterion == "ml":
        return _run_ml(args, out, names, leaves, n_states, weights, starts, constraint,
                       t1 - t0, mesh)
    return _run_parsimony(args, out, names, leaves, n_states, weights, starts, constraint,
                          t1 - t0, mesh)


def _run_distance(args, out, names, patterns, n_states, weights) -> InferRun:
    """``--criterion distance``: the NJ (or, with ``--start upgma``, UPGMA)
    tree of JC distances between the patterns' lowest states, its lengths
    clipped at 0; ``--bootstrap`` split supports (draws from a CPU
    generator seeded ``--seed``, as the JAX CLI seeds its key), dropped
    from the newick when ``--outgroup`` reroots it."""
    import numpy as np

    from trex_tpu_torch.cli._common import lowest_states
    from trex_tpu_torch.io import reroot_on_outgroup, save_newick
    from trex_tpu_torch.search.nj import nj_bootstrap, nj_start_tree

    device = weights.device
    method = args.start if args.start in ("nj", "upgma") else "nj"
    ints = torch.as_tensor(lowest_states(patterns, n_states), device=device)
    seconds: dict = {}
    clock = time.perf_counter()
    support = None
    if args.bootstrap > 0:
        topo, blens, support = nj_bootstrap(
            ints, n_states, n_replicates=args.bootstrap, method=method, site_weights=weights,
            generator=torch.Generator().manual_seed(args.seed), device=device, timings=seconds,
        )
        seconds["start"] = seconds.pop("reference")
        out["bootstrap_replicates"] = args.bootstrap
        out["split_support"] = [round(float(s), 3) for s in support]
    else:
        topo, blens = nj_start_tree(ints, n_states, weights, method=method, device=device)
        seconds["start"] = time.perf_counter() - clock
    blens = np.clip(np.asarray(blens, dtype=np.float64), 0.0, None)
    if args.outgroup:
        # Supports are indexed by the ancestors before the rerooting moves
        # them: dropped from the newick.
        support = None
        topo, blens = reroot_on_outgroup(topo, _outgroup_indices(names, args.outgroup), blens)
        out["outgroup"] = args.outgroup
    newick = save_newick(topo, names, branch_lengths=blens, support=support)
    out.update(method=method, tree=newick, tree_length=float(np.asarray(blens)[:-1].sum()))
    if args.output_tree and is_output_rank():
        with open(args.output_tree, "w") as fh:
            fh.write(newick + "\n")
    return InferRun(out, None, seconds, torch.as_tensor(blens, dtype=torch.float32))


def _constraint(args, names: list[str], out: dict):
    """(required splits, constraint taxa, constraint tree, its taxa's
    indices) of ``--constraint``, with the JAX CLI's refusals; records the
    counts in ``out``."""
    from trex_tpu_torch.io import load_newick
    from trex_tpu_torch.search.bootstrap import subtree_leaf_sets

    if args.neighborhood == "spr-scan":
        raise SystemExit(
            "--constraint needs an enumerating --neighborhood "
            "(nni/spr/tbr); the analytic spr-scan cannot filter moves"
        )
    if args.ratchet > 0:
        raise SystemExit("--constraint does not combine with --ratchet")
    if args.criterion == "ml" and args.model != "jc":
        raise SystemExit(
            "--constraint currently supports --model jc (the model-aware refinement "
            "rides the unfiltered scan)"
        )
    with open(args.constraint) as fh:
        ctopo, _, cnames = load_newick(fh.read())
    unknown = [n for n in cnames if n not in names]
    if unknown:
        raise SystemExit(f"constraint taxa not in alignment: {unknown[:5]}")
    cids = [names.index(n) for n in cnames]
    splits = []
    for clade in subtree_leaf_sets(ctopo):
        mapped = frozenset(cids[i] for i in clade)
        if 2 <= len(mapped) <= len(cids) - 2:
            splits.append(mapped)
    out["constraint_splits"] = len(splits)
    out["constraint_taxa"] = len(cids)
    return splits, frozenset(cids), ctopo, cids


def _run_parsimony(args, out, names, leaves, n_states, weights, starts, constraint,
                   start_seconds, mesh) -> InferRun:
    """The parsimony branch: a climb (or the ratchet) from each start, under
    ``constraint`` (required splits, constraint taxa) when given, the best
    score wins; then outgroup rooting, SPR-decay and bootstrap
    supports. The ratchet's and the bootstrap's draws come from CPU
    generators seeded as the JAX CLI seeds its keys (``--seed`` + start
    index, ``--seed`` + 1), so the card and the CPU draw alike."""
    import numpy as np

    from trex_tpu_torch.io import save_newick
    from trex_tpu_torch.types import CostModel

    device = leaves.device
    cost = CostModel.hamming(n_states, device=device).matrix
    seconds = {"start": start_seconds}
    clock = time.perf_counter()

    def lap(name: str) -> None:
        nonlocal clock
        _sync(device)
        now = time.perf_counter()
        seconds[name] = now - clock
        clock = now

    splits, taxa = constraint or (None, None)
    result = None
    generation: dict[str, float] = {}  # the enumerating climbs' host split
    for s_idx, st in enumerate(starts):
        if args.ratchet > 0:
            attempt = parsimony_ratchet(
                st, cost, leaves,
                generator=torch.Generator().manual_seed(args.seed + s_idx),
                n_iterations=args.ratchet, climb_rounds=args.rounds,
                neighborhood=args.neighborhood, site_weights=weights,
                sequences_are_masks=True, mesh=mesh,
            )
            out["ratchet_iterations"] = args.ratchet
        else:
            timings: dict[str, float] = {}
            attempt = parsimony_hill_climb(
                st, cost, leaves,
                max_rounds=args.rounds,
                neighborhood=args.neighborhood,
                site_weights=weights,
                sequences_are_masks=True,
                constraint_splits=splits,
                constraint_taxa=taxa,
                timings=timings,
                mesh=mesh,
            )
            for key, value in timings.items():
                generation[key] = generation.get(key, 0.0) + value
        if result is None or attempt.score < result.score:
            result = attempt
    lap("climb")
    seconds.update(generation)
    out["parsimony_score"] = result.score
    if args.outgroup:
        from trex_tpu_torch.io import reroot_on_outgroup

        # Unit-cost parsimony does not depend on the root: the score holds.
        topo, _ = reroot_on_outgroup(result.topology, _outgroup_indices(names, args.outgroup))
        result = dataclasses.replace(result, topology=topo)
        out["outgroup"] = args.outgroup
    if args.decay:
        from trex_tpu_torch.search.bremer import spr_decay_support

        decay, _ = spr_decay_support(result.topology, leaves, weights, sequences_are_masks=True,
                                     mesh=mesh)
        out["decay"] = [None if np.isnan(d) else round(float(d), 1) for d in decay]
        lap("decay")
    support = None
    if args.bootstrap > 0:
        from trex_tpu_torch.search.bootstrap import bootstrap_analysis

        support, _ = bootstrap_analysis(
            result.topology, cost, leaves,
            n_replicates=args.bootstrap,
            search_rounds=max(args.rounds // 4, 3),
            neighborhood="nni",
            site_weights=weights,
            sequences_are_masks=True,
            generator=torch.Generator().manual_seed(args.seed + 1),
            mesh=mesh,
        )
        out["bootstrap_replicates"] = args.bootstrap
        out["mean_split_support"] = float(np.mean(support))
        out["split_support"] = [round(float(s), 3) for s in support]
        lap("bootstrap")
    # Supports ride the newick as internal node labels.
    _finish(args, out, result, save_newick(result.topology, names, support=support))
    return InferRun(out, result, seconds)


def _finish(args, out: dict, result: SearchResult, newick: str) -> None:
    out.update(
        search_rounds=result.rounds,
        evaluations=result.evaluations,
        tree=newick,
    )
    if args.output_tree and is_output_rank():
        with open(args.output_tree, "w") as fh:
            fh.write(newick + "\n")


def _run_ml(args, out, names, leaves, n_states, weights, starts, constraint,
            start_seconds, mesh) -> InferRun:
    """The ML branch: a likelihood climb (under ``constraint`` when given),
    or with ``--ratchet`` the iterated search (kicks from numpy's
    ``default_rng(--seed + 13)``, the JAX CLI's key), from each start,
    then the Newton branch-length fit; the start with the lowest fitted
    NLL wins. With a ``--model`` other than jc, the model fit and the
    model <-> tree rounds (``_fit_model``); then ``--alrt`` and
    ``--ufboot`` supports (``_likelihood_supports``); with ``--bootstrap``,
    the ML bootstrap's split supports (draws from a CPU generator seeded
    ``--seed`` + 1, as the JAX CLI seeds its key)."""
    import numpy as np

    from trex_tpu_torch.io import save_newick
    from trex_tpu_torch.search.ml import ml_hill_climb, ml_iterated_search

    seconds: dict = {"start": start_seconds, "climb": 0.0, "newton": 0.0}
    splits, taxa = constraint or (None, None)
    best = None
    for st in starts:
        timings: dict = {}
        # Compressed patterns + weights are exact for ML too: the total
        # log-likelihood is a weighted per-site sum.
        if args.ratchet > 0:
            result, lengths, losses = ml_iterated_search(
                st, leaves, n_states, seed=args.seed + 13,
                n_iterations=args.ratchet, max_rounds=args.rounds,
                neighborhood=args.neighborhood, sequences_are_masks=True,
                site_weights=weights, timings=timings, mesh=mesh,
            )
            out["ml_iterations"] = args.ratchet
            seconds["climb"] += timings["climb"] + sum(timings["reclimbs"])
            seconds.setdefault("reclimbs", []).extend(timings["reclimbs"])
        else:
            result, lengths, losses = ml_hill_climb(
                st, leaves, n_states,
                max_rounds=args.rounds,
                neighborhood=args.neighborhood,
                sequences_are_masks=True,
                site_weights=weights,
                constraint_splits=splits,
                constraint_taxa=taxa,
                timings=timings,
                mesh=mesh,
            )
            seconds["climb"] += timings["climb"]
        seconds["newton"] += timings["newton"]
        if best is None or float(losses[-1]) < float(best[2][-1]):
            best = (result, lengths, losses)
    result, lengths, losses = best
    if args.outgroup:
        result, lengths = _reroot(args, names, result, lengths)
        out["outgroup"] = args.outgroup
    out.update(
        neg_log_likelihood=float(losses[-1]),
        ranking_score=result.score,
        model=args.model,
    )
    params: dict = {}
    if args.model != "jc":
        result, lengths, params = _fit_model(args, out, names, leaves, n_states, weights,
                                             result, seconds, mesh)
    support = _likelihood_supports(args, out, leaves, n_states, weights, result, params,
                                   seconds, mesh)
    lengths_np = lengths.cpu().numpy()
    newick = save_newick(result.topology, names, lengths_np, support=support)
    out["mean_branch_length"] = float(lengths_np.mean())
    if args.bootstrap > 0:
        from trex_tpu_torch.search.bootstrap import ml_bootstrap_analysis

        clock = time.perf_counter()
        support, _ = ml_bootstrap_analysis(
            result.topology, leaves, n_states,
            n_replicates=args.bootstrap,
            search_rounds=max(args.rounds // 4, 3),
            site_weights=weights,
            sequences_are_masks=True,
            generator=torch.Generator().manual_seed(args.seed + 1),
            mesh=mesh,
        )
        _sync(leaves.device)
        seconds["bootstrap"] = time.perf_counter() - clock
        out["bootstrap_replicates"] = args.bootstrap
        out["mean_split_support"] = float(np.mean(support))
        out["split_support"] = [round(float(s), 3) for s in support]
    _finish(args, out, result, newick)
    return InferRun(out, result, seconds, lengths)


def _likelihood_supports(args, out, leaves, n_states, weights, result, params, seconds, mesh):
    """``--alrt`` (``search.alrt.branch_supports``, draws from a CPU
    generator seeded ``--seed`` + 7) and ``--ufboot``
    (``search.ufboot.ultrafast_bootstrap``, ``--seed`` + 11, also its TBR
    sample's seed), as the JAX CLI seeds its keys, under the fitted
    exchangeabilities and frequencies when ``--model`` is not jc (a rate
    mixture is not passed, as in the JAX CLI). Records them in ``out``;
    returns the newick's support labels (UFBoot's when both ran) or
    None."""
    import numpy as np

    rates = params.get("rates")
    freqs = params.get("freqs")
    support = None
    if args.alrt > 0:
        from trex_tpu_torch.search.alrt import branch_supports

        parts: dict = {}
        clock = time.perf_counter()
        sup = branch_supports(
            result.topology, leaves, n_states, rates=rates, freqs=freqs,
            site_weights=weights, n_replicates=args.alrt, sequences_are_masks=True,
            generator=torch.Generator().manual_seed(args.seed + 7), timings=parts, mesh=mesh,
        )
        _sync(leaves.device)
        seconds.update(alrt=time.perf_counter() - clock, alrt_parts=parts)
        support = sup.sh_alrt
        out["alrt"] = [None if np.isnan(v) else round(float(v), 3) for v in sup.alrt]
        out["sh_alrt_support"] = [round(float(s), 3) for s in sup.sh_alrt]
        out["rell_support"] = [round(float(s), 3) for s in sup.rell]
    if args.ufboot > 0:
        from trex_tpu_torch.search.ufboot import ultrafast_bootstrap

        parts = {}
        clock = time.perf_counter()
        ub = ultrafast_bootstrap(
            result.topology, leaves, n_states, rates=rates, freqs=freqs,
            site_weights=weights, n_replicates=args.ufboot, sequences_are_masks=True,
            seed=args.seed + 11, generator=torch.Generator().manual_seed(args.seed + 11),
            timings=parts, mesh=mesh,
        )
        _sync(leaves.device)
        seconds.update(ufboot=time.perf_counter() - clock, ufboot_parts=parts)
        out["ufboot_support"] = [round(float(s), 3) for s in ub.support]
        out["ufboot_candidates"] = ub.n_candidates
        out["ufboot_reference_wins"] = int(ub.winner_counts[ub.reference_index])
        support = ub.support  # UFBoot's labels win when both ran
    return support


def _reroot(args, names, result: SearchResult, lengths: torch.Tensor):
    from trex_tpu_torch.io import reroot_on_outgroup

    topo, rerooted = reroot_on_outgroup(
        result.topology, _outgroup_indices(names, args.outgroup), lengths.cpu().numpy())
    return (dataclasses.replace(result, topology=topo),
            torch.as_tensor(rerooted, dtype=torch.float32, device=lengths.device))


def _mixture_kwargs(params: dict) -> dict:
    """The rate mixture the scan ranks under after a fit: +rK's categories
    as fitted, +I as an extra rate-0 class (after the four Gamma ones under
    +G+I), +G by its shape."""
    import numpy as np

    from trex_tpu_torch.ops.likelihood import discrete_gamma_rates

    if "category_rates" in params:
        return dict(category_rates=params["category_rates"],
                    category_weights=params["category_weights"])
    if "p_invariant" in params:
        p_inv = float(params["p_invariant"])
        g = (
            discrete_gamma_rates(float(params["gamma_shape"]), 4).numpy()
            if "gamma_shape" in params else np.ones((1,))
        )
        device = params["p_invariant"].device
        return dict(
            category_rates=torch.as_tensor(
                np.concatenate([g, [0.0]]), dtype=torch.float32, device=device),
            category_weights=torch.as_tensor(
                np.concatenate([np.full(g.size, (1.0 - p_inv) / g.size), [p_inv]]),
                dtype=torch.float32, device=device),
        )
    if "gamma_shape" in params:
        return dict(gamma_shape=params["gamma_shape"])
    return {}


def _fit_model(args, out, names, leaves, n_states, weights, result, seconds, mesh):
    """``optimize_model`` on the climbed tree, then up to
    ``--model-rounds`` rounds of climbing under the fitted model (rate
    mixture aware on the scan) and refitting, stopping when the topology
    holds. Records the fitted parameters in ``out``; returns the final
    (result, branch lengths, fitted parameters). ``seconds`` gains "fit"
    (the first fit) and "rounds" (the model rounds)."""
    import numpy as np

    from trex_tpu_torch.io import parse_paml_rates
    from trex_tpu_torch.ops.likelihood import optimize_model
    from trex_tpu_torch.search.ml import ml_hill_climb

    device = leaves.device
    fixed_rates = fixed_freqs = None
    if args.model_file:
        with open(args.model_file) as fh:
            fixed_rates, fixed_freqs = parse_paml_rates(fh.read(), n_states)

    def fit(topology):
        return optimize_model(
            topology, leaves, n_states, model=args.model, sequences_are_masks=True,
            site_weights=weights, fixed_rates=fixed_rates, fixed_freqs=fixed_freqs,
        )

    clock = time.perf_counter()
    params, model_losses = fit(result.topology)
    out["neg_log_likelihood"] = float(model_losses[-1])
    seconds["fit"] = time.perf_counter() - clock
    clock = time.perf_counter()
    for _ in range(args.model_rounds):
        if "rates" not in params:
            break  # jc+g and the like: the ranking model does not change
        previous = result.topology.children.cpu().numpy().tobytes()
        mixture = _mixture_kwargs(params) if args.neighborhood == "spr-scan" else {}
        result, _, _ = ml_hill_climb(
            result.topology, leaves, n_states,
            max_rounds=args.rounds, neighborhood=args.neighborhood,
            sequences_are_masks=True, site_weights=weights,
            rates=params["rates"], freqs=params["freqs"], mesh=mesh, **mixture,
        )
        params, model_losses = fit(result.topology)
        out["neg_log_likelihood"] = float(model_losses[-1])
        out["model_rounds"] = out.get("model_rounds", 0) + 1
        if result.topology.children.cpu().numpy().tobytes() == previous:
            break
    _sync(device)
    seconds["rounds"] = time.perf_counter() - clock
    lengths = params["branch_lengths"]
    if out.get("model_rounds") and args.outgroup:
        # The rooting again, on whatever tree the rounds settled on.
        result, lengths = _reroot(args, names, result, lengths)

    def rounded(x, digits):
        return np.round(x.cpu().numpy(), digits).tolist()

    # The JAX CLI raises KeyError for a jc base here (no "rates"); the port
    # prints null exchangeabilities and the uniform frequencies.
    fitted = "rates" in params and not args.model.startswith("empirical")
    out["gtr_rates"] = rounded(params["rates"], 5) if fitted else None
    out["base_frequencies"] = rounded(
        params["freqs"] if "freqs" in params
        else torch.full((n_states,), 1.0 / n_states), 5)
    for name in ("gamma_shape", "p_invariant", "kappa", "kappa_purine", "kappa_pyrimidine"):
        if name in params:
            out[name] = float(params[name])
    if "category_rates" in params:
        out["category_rates"] = rounded(params["category_rates"], 4)
        out["category_weights"] = rounded(params["category_weights"], 4)
    return result, lengths, params


def cmd_infer(args) -> None:
    out = run_infer(args).out
    if is_output_rank():
        print(json.dumps(out))
