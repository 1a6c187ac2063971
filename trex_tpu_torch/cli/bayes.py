"""Concordance factors (the ``concord`` command of
``trex_tpu/cli/bayes.py``): gene and site concordance factors of a
reference tree's branches (``search.concordance``, host numpy; the sCF
quartets drawn by ``np.random.default_rng(--seed)``, as the JAX command
draws them). The module's Bayesian commands (``mcmc``, ``bayesfactor``,
``date``) are not ported yet.
"""

from __future__ import annotations

import json

import numpy as np

from trex_tpu_torch.cli._common import _load_alignment
from trex_tpu_torch.cli.trees import _read_trees


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
