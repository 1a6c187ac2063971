"""Model-centric commands: ``partition``, ``modeltest`` and ``dnds``
(counterpart of ``trex_tpu/cli/models.py``)."""

from __future__ import annotations

import json

import numpy as np
import torch

from trex_tpu_torch._device import resolve_device
from trex_tpu_torch.cli._common import _load_alignment


def _fixed_tree(args, names, masks, n_states, device):
    """``--tree``, its leaves put in the alignment's order, else the
    stepwise-addition tree of the masks from ``--seed``."""
    if args.tree:
        from trex_tpu_torch.io import align_leaf_order, load_newick

        with open(args.tree) as fh:
            topo, _, tree_names = load_newick(fh.read())
        if sorted(tree_names) != sorted(names):
            raise SystemExit("tree and alignment taxa differ")
        return align_leaf_order(topo, tree_names, names).to(device)
    from trex_tpu_torch.search.stepwise import stepwise_addition

    topo, _ = stepwise_addition(masks, n_states, sequences_are_masks=True, seed=args.seed,
                                device=device)
    return topo


def run_partition(args, timings: dict | None = None) -> dict:
    """The ``partition`` command's JSON object: a partitioned ML fit
    (``ops.likelihood.optimize_model_partitioned``) on ``--tree`` or the
    stepwise tree; with ``--search``, a climb under the fitted partitioned
    model (``search.ml.ml_partitioned_scan_climb``), refitted when the
    topology moved. ``timings``: a dict that, when given, receives the
    wall seconds of the start tree (``"start"``), the fits (``"fits"``, a
    list) and the climb (``"search"``) with its summed scan rounds
    (``"scan_rounds"``)."""
    import time

    from trex_tpu_torch.io import parse_partitions
    from trex_tpu_torch.ops import likelihood

    device = resolve_device(args.device)
    timings = {} if timings is None else timings
    names, masks, n_states = _load_alignment(args.fasta, args.alphabet)
    with open(args.partitions) as fh:
        pids, part_names, part_types = parse_partitions(fh.read(), int(masks.shape[1]))
    clock = time.perf_counter()
    topo = _fixed_tree(args, names, masks, n_states, device)
    timings["start"] = time.perf_counter() - clock
    n_parts = len(part_names)
    models = (
        [m.strip() for m in args.models.split(",")] if args.models else [args.model] * n_parts
    )
    leaves = torch.as_tensor(masks, device=device)

    def fit(topology):
        clock = time.perf_counter()
        result, _ = likelihood.optimize_model_partitioned(
            topology, leaves, n_states, pids, models=models, linked=args.linked,
            n_iterations=args.iterations, sequences_are_masks=True,
        )
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        timings.setdefault("fits", []).append(time.perf_counter() - clock)
        return result

    result = fit(topo)
    search_rounds = None
    if args.search:
        # The joint ranking table is the sum of the partitions' analytic
        # scans, each under its fitted model and rate multiplier.
        from trex_tpu_torch.search.ml import ml_partitioned_scan_climb

        parts = []
        for p in range(n_parts):
            pp = result["partitions"][p]
            parts.append(dict(
                leaf_sequences=leaves[:, torch.as_tensor(pids == p, device=device)],
                rates=pp.get("rates"), freqs=pp.get("freqs"),
                gamma_shape=float(pp["gamma_shape"]) if "gamma_shape" in pp else None,
                rate_multiplier=float(result["rate_multipliers"][p]),
            ))
        clock = time.perf_counter()
        sr = ml_partitioned_scan_climb(topo, parts, n_states, sequences_are_masks=True,
                                       timings=timings)
        timings["search"] = time.perf_counter() - clock
        search_rounds = sr.rounds
        if not torch.equal(sr.topology.children.cpu(), topo.children.cpu()):
            topo = sr.topology
            result = fit(topo)
    lls = [float(result["partitions"][p]["log_likelihood"]) for p in range(n_parts)]
    lengths = result["branch_lengths"].cpu().numpy()
    out = {
        "n_taxa": len(names),
        "n_sites": int(masks.shape[1]),
        "linked": args.linked,
        # The partitions' lnLs at the final parameters (the last loss is one
        # step behind).
        "log_likelihood": float(sum(lls)),
        "tree_length": float(lengths[:-1].sum()),
        "partitions": [],
    }
    if search_rounds is not None:
        out["search_rounds"] = search_rounds
    for p in range(n_parts):
        part = result["partitions"][p]
        entry = {
            "name": part_names[p],
            "type": part_types[p],
            "model": models[p],
            "n_sites": int((pids == p).sum()),
            "rate_multiplier": round(float(result["rate_multipliers"][p]), 4),
            "log_likelihood": lls[p],
        }
        if "gamma_shape" in part:
            entry["gamma_shape"] = round(float(part["gamma_shape"]), 4)
        if "freqs" in part:
            entry["frequencies"] = np.round(part["freqs"].cpu().numpy(), 4).tolist()
        out["partitions"].append(entry)
    if args.output_tree:
        from trex_tpu_torch.io import save_newick

        with open(args.output_tree, "w") as fh:
            fh.write(save_newick(topo, names, lengths) + "\n")
        out["output_tree"] = args.output_tree
    return out


def cmd_partition(args) -> None:
    """Partitioned ML model fit: a model per partition, one shared tree."""
    print(json.dumps(run_partition(args)))


def run_modeltest(args, timings: dict | None = None) -> dict:
    """The ``modeltest`` command's JSON object: every ``--models``
    candidate fitted on ``--tree`` (or the stepwise tree) over the
    compressed patterns, ranked by ``--criterion``. ``timings``: a dict
    that, when given, maps each model to its fit's wall seconds."""
    from trex_tpu_torch.alignment import compress_alignment
    from trex_tpu_torch.search.model_select import compare_models

    device = resolve_device(args.device)
    names, masks, n_states = _load_alignment(args.fasta, args.alphabet)
    patterns, weights = compress_alignment(masks)
    topo = _fixed_tree(args, names, masks, n_states, device)
    fixed_rates = fixed_freqs = None
    models = tuple(m.strip() for m in args.models.split(",") if m.strip())
    if args.model_file:
        from trex_tpu_torch.io import parse_paml_rates

        with open(args.model_file) as fh:
            fixed_rates, fixed_freqs = parse_paml_rates(fh.read(), n_states)
        fixed_rates = torch.as_tensor(fixed_rates, dtype=torch.float32, device=device)
        fixed_freqs = torch.as_tensor(fixed_freqs, dtype=torch.float32, device=device)
    fits = compare_models(
        topo, torch.as_tensor(np.asarray(patterns, dtype=np.int32), device=device), n_states,
        models=models, criterion=args.criterion,
        site_weights=torch.as_tensor(weights, dtype=torch.float32, device=device),
        sequences_are_masks=True, n_iterations=args.iterations,
        fixed_rates=fixed_rates, fixed_freqs=fixed_freqs, timings=timings,
    )
    return {
        "criterion": args.criterion,
        "best": fits[0].model,
        "n_taxa": len(names),
        "n_sites": int(masks.shape[1]),
        "table": [
            {
                "model": f.model,
                "log_likelihood": round(f.log_likelihood, 3),
                "n_parameters": f.n_parameters,
                "aic": round(f.aic, 3),
                "aicc": round(f.aicc, 3),
                "bic": round(f.bic, 3),
            }
            for f in fits
        ],
    }


def cmd_modeltest(args) -> None:
    """Substitution-model selection by AIC/AICc/BIC on a fixed topology."""
    print(json.dumps(run_modeltest(args)))


def run_dnds(args, timings: dict | None = None) -> dict:
    """The ``dnds`` command's JSON object: GY94 (``--model gy94|gy94+g``)
    fitted by ``models.codon.optimize_gy94`` on ``--tree`` or the
    stepwise-addition tree of the nucleotide masks (K2 on the card); with
    ``--search``, the SPR-scan ML climb at Q = 61 under the fitted kappa
    and omega, then a refit when the topology moved. ``timings``: a dict
    that, when given, gets the wall seconds of the start tree
    (``"start"``), each fit (``"fits"``, a list) and the climb
    (``"search"``)."""
    import time

    from trex_tpu_torch.alignment import compress_alignment
    from trex_tpu_torch.io import save_newick
    from trex_tpu_torch.models import codon as cd

    device = resolve_device(args.device)
    timings = {} if timings is None else timings
    names, masks, n_states = _load_alignment(args.fasta, "dna")
    # Codon states want plain bases: a single-bit mask is its base, anything
    # ambiguous (a gap, an IUPAC code) -1, so the whole codon goes missing.
    ints = np.full(masks.shape, -1, dtype=np.int32)
    for b in range(4):
        ints[masks == (1 << b)] = b
    codons = cd.encode_codons(ints, stops=args.stops)
    n_missing = int((codons < 0).sum())

    def synced(key, fn):
        clock = time.perf_counter()
        out = fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        seconds = time.perf_counter() - clock
        if key == "fits":
            timings.setdefault("fits", []).append(seconds)
        else:
            timings[key] = seconds
        return out

    topo = synced("start", lambda: _fixed_tree(args, names, masks, n_states, device))
    tree_source = args.tree or "stepwise addition (nucleotide parsimony)"
    freqs = cd.codon_frequencies(codons, mode=args.freqs, nuc_states=ints)
    patterns, weights = compress_alignment(codons)
    leaves = torch.as_tensor(patterns.astype(np.int32), device=device)
    site_weights = torch.as_tensor(weights.astype(np.float32), device=device)

    def fit(topology):
        return synced("fits", lambda: cd.optimize_gy94(
            topology, leaves, freqs=freqs, model=args.model, n_iterations=args.iterations,
            site_weights=site_weights))

    params, losses = fit(topo)
    if args.search:
        # Codon-model tree search: the analytic SPR scan ranks candidates
        # under GY94 at the fitted kappa and omega (a reversible 61-state
        # model), then the full model is refitted on the winning topology.
        from trex_tpu_torch.search.ml import ml_hill_climb

        s_matrix = cd.gy94_exchangeabilities(params["kappa"], params["omega"])
        result, _, _ = synced("search", lambda: ml_hill_climb(
            topo, leaves, cd.N_CODONS, neighborhood="spr-scan", site_weights=site_weights,
            rates=s_matrix, freqs=torch.as_tensor(freqs, device=device),
            optimize_final_lengths=False, device=device))
        if not torch.equal(result.topology.children, topo.children):
            topo = result.topology
            params, losses = fit(topo)
        tree_source = f"{tree_source} + GY94 SPR-scan search"
    lengths = params["branch_lengths"].cpu().numpy()
    out = {
        "model": args.model,
        "codon_frequencies": args.freqs,
        "tree_source": tree_source,
        "n_taxa": len(names),
        "n_codons": int(codons.shape[1]),
        "unique_codon_patterns": int(patterns.shape[1]),
        "missing_codons": n_missing,
        "kappa": round(float(params["kappa"]), 4),
        "omega": round(float(params["omega"]), 4),
        "log_likelihood": -float(losses[-1]),
        "tree_length": float(lengths[:-1].sum()),
    }
    if "gamma_shape" in params:
        out["gamma_shape"] = round(float(params["gamma_shape"]), 4)
    if args.output_tree:
        with open(args.output_tree, "w") as fh:
            fh.write(save_newick(topo, names, lengths) + "\n")
        out["output_tree"] = args.output_tree
    return out


def cmd_dnds(args) -> None:
    """GY94 codon-model fit (dN/dS) on a coding nucleotide alignment."""
    print(json.dumps(run_dnds(args)))
