"""Tree-file commands (counterpart of ``trex_tpu/cli/trees.py``):

- ``treedist``: Robinson-Foulds distance between two newick trees, with
  the branch-score, weighted RF and path-difference distances when both
  carry lengths (host numpy);
- ``consensus``: the majority-rule consensus of a multi-newick file;
- ``topotest``: KH / SH / BP / ELW / AU tests of candidate trees on one
  alignment (``search.topotest``: the batched Newton fit and K4's per-site
  rows on the card), with the model fixed at its ML estimates on the first
  tree and the CONSEL-format ``--site-lnl`` file;
- ``treeprune``: the induced subtree (and alignment rows) of a taxa subset.

Each prints the JAX command's JSON. ``topotest`` draws its replicates from
a CPU generator seeded ``--seed`` (the JAX command's key), then its AU
scales from the same generator.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from trex_tpu_torch._device import resolve_device
from trex_tpu_torch.cli._common import _join_world, _load_alignment
from trex_tpu_torch.parallel.mesh import is_output_rank


def _read_trees(path: str) -> list[str]:
    """The newick strings of a file, one per line or ;-separated."""
    with open(path) as fh:
        text = fh.read()
    return [c.strip() + ";" for c in text.split(";") if c.strip()]


def run_treedist(args) -> dict:
    """The printed JSON object of ``treedist``."""
    from trex_tpu_torch.io import load_newick, renumber_leaves
    from trex_tpu_torch.search.bootstrap import subtree_leaf_sets
    from trex_tpu_torch.search.ratchet import unrooted_splits
    from trex_tpu_torch.search.treedist import (
        branch_score_distance,
        path_difference_distance,
        weighted_rf_distance,
    )

    def named_splits(path):
        """Splits as name sets, on the side without the lexicographically
        first taxon (index-based sides differ per tree)."""
        with open(path) as fh:
            topo, blens, names = load_newick(fh.read())
        anchor = min(names)
        all_names = frozenset(names)
        splits = set()
        for split in unrooted_splits(topo):
            side = frozenset(names[i] for i in split)
            splits.add(all_names - side if anchor in side else side)
        return topo, np.asarray(blens, dtype=np.float64), names, splits

    topo_a, blens_a, names_a, splits_a = named_splits(args.trees[0])
    topo_b, blens_b, names_b, splits_b = named_splits(args.trees[1])
    if set(names_a) != set(names_b):
        raise SystemExit("trees have different leaf sets")
    rf = len(splits_a ^ splits_b)
    max_rf = 2 * (topo_a.n_leaves - 3)
    out = {
        "rf": int(rf),
        "max_rf": int(max_rf),
        "normalized": float(rf / max_rf) if max_rf > 0 else 0.0,
    }
    if np.isfinite(blens_a[:-1]).all() and np.isfinite(blens_b[:-1]).all():
        # The length-aware metrics key splits by leaf set: put b on a's
        # leaf numbering, its lengths following their leaves and clades.
        order = {n: i for i, n in enumerate(names_a)}
        perm = [order[n] for n in names_b]
        topo_b2 = renumber_leaves(topo_b, perm)
        lookup = {frozenset(perm[i] for i in s): blens_b[topo_b.n_leaves + i]
                  for i, s in enumerate(subtree_leaf_sets(topo_b))}
        new_lens = np.zeros_like(blens_b)
        for leaf_old, leaf_new in enumerate(perm):
            new_lens[leaf_new] = blens_b[leaf_old]
        for i, s in enumerate(subtree_leaf_sets(topo_b2)):
            new_lens[topo_b2.n_leaves + i] = lookup[s]
        for key, metric in (("branch_score", branch_score_distance),
                            ("weighted_rf", weighted_rf_distance),
                            ("path_difference", path_difference_distance)):
            out[key] = round(metric(topo_a, blens_a, topo_b2, new_lens), 6)
    return out


def cmd_treedist(args) -> None:
    print(json.dumps(run_treedist(args)))


def run_consensus(args) -> dict:
    """The printed JSON object of ``consensus``."""
    from trex_tpu_torch.io import load_newick, renumber_leaves
    from trex_tpu_torch.search.consensus import majority_rule_consensus

    chunks = _read_trees(args.trees)
    if not chunks:
        raise SystemExit(f"{args.trees}: no trees found")
    topos = []
    ref_names: list[str] | None = None
    order: dict[str, int] = {}
    for chunk in chunks:
        topo, _, names = load_newick(chunk)
        if ref_names is None:
            ref_names = names
            order = {n: i for i, n in enumerate(names)}
        elif sorted(names) != sorted(ref_names):
            raise SystemExit("trees have different leaf sets")
        topos.append(renumber_leaves(topo, [order[n] for n in names]))
    newick, kept = majority_rule_consensus(topos, ref_names, threshold=args.threshold)
    if args.output_tree:
        with open(args.output_tree, "w") as fh:
            fh.write(newick + "\n")
    return {"n_trees": len(topos), "threshold": args.threshold, "n_splits": len(kept),
            "tree": newick}


def cmd_consensus(args) -> None:
    print(json.dumps(run_consensus(args)))


def run_topotest(args, timings: dict | None = None) -> tuple[dict, object]:
    """The printed JSON object of ``topotest`` and its
    ``TopologyTestResult``. ``timings`` gains the model fit's seconds
    ("model") and ``topology_tests``'s. With ``--mesh`` (or a launcher's
    world of more than one rank) the candidates' fits split over the mesh's
    'tree' axis; only rank 0 writes ``--site-lnl``."""
    import time

    from trex_tpu_torch.alignment import compress_alignment
    from trex_tpu_torch.io import load_newick, parse_paml_rates, renumber_leaves
    from trex_tpu_torch.ops.likelihood import optimize_model
    from trex_tpu_torch.search.topotest import topology_tests
    from trex_tpu_torch.topology import Topology

    mesh = _join_world(args)
    device = resolve_device(args.device)
    names, masks, n_states = _load_alignment(args.fasta, args.alphabet)
    patterns, counts = compress_alignment(masks)
    order = {n: i for i, n in enumerate(names)}
    topos = []
    for chunk in _read_trees(args.trees):
        topo, _, tree_names = load_newick(chunk)
        if sorted(tree_names) != sorted(names):
            raise SystemExit("tree leaf set differs from the alignment")
        topos.append(renumber_leaves(topo, [order[n] for n in tree_names]))
    if len(topos) < 2:
        raise SystemExit("topotest needs at least two candidate trees")
    batch = Topology(torch.stack([t.children for t in topos]).to(device),
                     torch.stack([t.parents for t in topos]).to(device))
    leaves = torch.as_tensor(np.asarray(patterns, dtype=np.int32), device=device)
    weights = torch.as_tensor(counts, dtype=torch.float32, device=device)

    rates = freqs = None
    if args.model != "jc":
        fixed_rates = fixed_freqs = None
        if args.model_file:
            with open(args.model_file) as fh:
                fixed_rates, fixed_freqs = parse_paml_rates(fh.read(), n_states)
        # The model fixed at its ML estimates on the first tree (the
        # standard topology-test protocol).
        clock = time.perf_counter()
        params, _ = optimize_model(
            topos[0].to(device), leaves, n_states, model=args.model, sequences_are_masks=True,
            site_weights=weights, fixed_rates=fixed_rates, fixed_freqs=fixed_freqs,
        )
        rates, freqs = params.get("rates"), params.get("freqs")
        if timings is not None:
            timings["model"] = time.perf_counter() - clock
    res = topology_tests(
        batch, leaves, n_states, rates=rates, freqs=freqs, site_weights=weights,
        n_replicates=args.replicates, sequences_are_masks=True,
        generator=torch.Generator().manual_seed(args.seed), timings=timings, mesh=mesh,
    )
    if args.site_lnl and is_output_rank():
        # Per-pattern values back in site order: the CONSEL/puzzle site-lnL
        # matrix ("T L" header, one row per tree).
        _, first_idx, inverse = np.unique(masks, axis=1, return_index=True, return_inverse=True)
        rank = np.empty_like(first_idx)
        rank[np.argsort(first_idx)] = np.arange(first_idx.size)
        site_lnl = res.per_site[:, rank[inverse.ravel()]]
        with open(args.site_lnl, "w") as fh:
            fh.write(f"{site_lnl.shape[0]} {site_lnl.shape[1]}\n")
            for t in range(site_lnl.shape[0]):
                fh.write(f"tree{t + 1} " + " ".join(f"{v:.6f}" for v in site_lnl[t]) + "\n")
    out = {
        "n_trees": len(topos),
        "replicates": args.replicates,
        "model": args.model,
        "best": res.best_index,
        "table": [
            {
                "tree": i,
                "log_likelihood": round(float(res.log_likelihoods[i]), 3),
                "delta": round(float(res.delta[i]), 3),
                "p_kh": round(float(res.p_kh[i]), 4),
                "p_sh": round(float(res.p_sh[i]), 4),
                "p_au": None if res.p_au is None else round(float(res.p_au[i]), 4),
                "bp": round(float(res.bp[i]), 4),
                "elw": round(float(res.elw[i]), 4),
            }
            for i in range(len(topos))
        ],
    }
    return out, res


def cmd_topotest(args) -> None:
    out = run_topotest(args)[0]
    if is_output_rank():
        print(json.dumps(out))


def run_treeprune(args) -> dict:
    """The printed JSON object of ``treeprune``."""
    from trex_tpu_torch.io import _split_fasta, load_newick, prune_to_taxa, save_newick

    with open(args.tree) as fh:
        topo, blens, names = load_newick(fh.read())
    wanted = [s.strip() for s in args.taxa.split(",") if s.strip()]
    missing = [w for w in wanted if w not in names]
    if missing:
        raise SystemExit(f"taxa not in the tree: {missing}")
    if args.invert:
        wanted = [n for n in names if n not in set(wanted)]
    keep = [names.index(w) for w in wanted]
    blens = np.asarray(blens)
    has_lengths = np.isfinite(blens[:-1]).all() and (blens[:-1] > 0).any()
    pruned, new_blens, kept = prune_to_taxa(topo, keep, blens if has_lengths else None)
    new_names = [names[i] for i in kept]
    newick = save_newick(pruned, new_names, branch_lengths=new_blens)
    if args.output_tree:
        with open(args.output_tree, "w") as fh:
            fh.write(newick + "\n")
    if args.alignment:
        with open(args.alignment) as fh:
            aln_names, rows = _split_fasta(fh.read())
        by_name = dict(zip(aln_names, rows))
        missing_aln = [n for n in new_names if n not in by_name]
        if missing_aln:
            raise SystemExit(f"taxa not in the alignment: {missing_aln}")
        with open(args.output_alignment or "pruned.fasta", "w") as fh:
            for n in new_names:
                fh.write(f">{n}\n{by_name[n].tobytes().decode('ascii')}\n")
    return {"kept": len(new_names), "dropped": len(names) - len(new_names), "tree": newick}


def cmd_treeprune(args) -> None:
    print(json.dumps(run_treeprune(args)))
