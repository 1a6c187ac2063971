"""Gene and site concordance factors (gCF / sCF) (counterpart of
``trex_tpu/search/concordance.py``).

The IQ-TREE genealogical-concordance workflow (Minh, Hahn & Lanfear 2020,
MBE 37:2727), host numpy. For every internal branch of a reference tree:

- **gCF**: the share of gene trees (inferred per locus) that contain the
  branch's split, by split arithmetic on the canonical clade sets;
- **sCF**: the mean share of decisive alignment sites supporting the
  split over random quartets drawn around the branch (one leaf from each
  of the four adjacent subtrees), each branch's quartets compared in one
  vectorized pass over the alignment; sites with any ambiguity in the
  quartet are excluded (the standard decisiveness rule). The quartets are
  drawn by ``np.random.default_rng(seed)``, as the JAX package draws them.

Summaries pair naturally with bootstrap/aLRT supports: low gCF/sCF with
high bootstrap flags branches whose signal is concentrated or conflicting.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from trex_tpu_torch.topology import Topology


@dataclasses.dataclass
class ConcordanceResult:
    """Per-branch concordance factors, indexed like ``reference.children``
    (entry i = the edge above ancestor ``n_leaves + i``; root and
    root-adjacent duplicates are NaN)."""

    gcf: np.ndarray | None
    """(n_ancestors,) gene concordance factor in [0, 1], or None."""
    gcf_n: np.ndarray | None
    """(n_ancestors,) number of gene trees counted per branch."""
    scf: np.ndarray | None
    """(n_ancestors,) site concordance factor in [0, 1], or None."""
    scf_n: np.ndarray | None
    """(n_ancestors,) mean decisive sites per quartet, or None."""


def _internal_branches(reference: Topology):
    """Ancestors owning a distinct internal (unrooted-nontrivial) edge.

    Returns (ancestor_offsets, groups) where groups[i] = four disjoint leaf
    index lists (the subtrees adjacent to the edge). Root is skipped; of
    the two root-child edges (one unrooted edge) only the first ancestor
    child is kept.
    """
    from trex_tpu_torch.search.bootstrap import subtree_leaf_sets

    n_leaves = reference.n_leaves
    n_all = reference.n_all
    children, _ = reference.to_numpy()
    clades = subtree_leaf_sets(reference)
    clade_of = {n_leaves + i: c for i, c in enumerate(clades)}
    for leaf in range(n_leaves):
        clade_of[leaf] = frozenset([leaf])
    parents = np.arange(n_all)
    for a in range(n_leaves - 1):
        parents[children[a]] = n_leaves + a
    every = frozenset(range(n_leaves))
    root = n_all - 1
    root_kids = [int(c) for c in children[root - n_leaves]]

    out = []
    for a in range(n_leaves - 1):
        v = n_leaves + a
        if v == root:
            continue
        p = int(parents[v])
        kid_a, kid_b = (int(c) for c in children[a])
        group_a = clade_of[kid_a]
        group_b = clade_of[kid_b]
        if p == root:
            sib = root_kids[0] if root_kids[1] == v else root_kids[1]
            if sib < n_leaves:
                continue  # pendant edge in the unrooted view: trivial
            if v == max(rk for rk in root_kids if rk >= n_leaves) and all(
                rk >= n_leaves for rk in root_kids
            ):
                continue  # same unrooted edge as the other root child's
            sib_kids = [int(c) for c in children[sib - n_leaves]]
            group_c = clade_of[sib_kids[0]]
            group_d = clade_of[sib_kids[1]]
        else:
            pa = p - n_leaves
            sib = int(
                children[pa][0]
                if int(children[pa][1]) == v
                else children[pa][1]
            )
            group_c = clade_of[sib]
            group_d = every - clade_of[p]
            if not group_d:
                continue  # parent edge is the root split seen from below
        out.append((a, (sorted(group_a), sorted(group_b),
                        sorted(group_c), sorted(group_d))))
    return out


def gene_concordance(
    reference: Topology, gene_trees: list[Topology]
) -> tuple[np.ndarray, np.ndarray]:
    """gCF per reference ancestor: fraction of gene trees with the split.

    Splits are compared unrooted (clade or complement). Returns
    (gcf (n_anc,), counts (n_anc,)); entries with no defined internal edge
    (root / duplicate root edge) are NaN.
    """
    from trex_tpu_torch.search.bootstrap import subtree_leaf_sets

    n_leaves = reference.n_leaves
    every = frozenset(range(n_leaves))

    def unrooted(tree: Topology) -> set[frozenset[int]]:
        sets = set()
        for s in subtree_leaf_sets(tree):
            if 1 < len(s) < n_leaves - 1:
                sets.add(min(s, every - s, key=lambda x: (len(x), sorted(x))))
            # size n-1 clades are pendant edges: trivial
        return sets

    gene_splits = [unrooted(t) for t in gene_trees]
    ref_clades = subtree_leaf_sets(reference)
    n_anc = n_leaves - 1
    gcf = np.full(n_anc, np.nan)
    counts = np.zeros(n_anc)
    branches = {a for a, _ in _internal_branches(reference)}
    for a in branches:
        s = ref_clades[a]
        if not (1 < len(s) < n_leaves - 1):
            continue
        key = min(s, every - s, key=lambda x: (len(x), sorted(x)))
        hits = sum(1 for gs in gene_splits if key in gs)
        gcf[a] = hits / max(len(gene_trees), 1)
        counts[a] = len(gene_trees)
    return gcf, counts


def site_concordance(
    reference: Topology,
    leaf_sequences: np.ndarray,
    *,
    n_quartets: int = 100,
    seed: int = 0,
    sequences_are_masks: bool = False,
    site_weights: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """sCF per reference ancestor (mean over random quartets around the
    branch of the fraction of decisive sites supporting the split).

    A site is *decisive* for quartet (a, b | c, d) if all four leaves are
    unambiguous there and the pattern matches one of the three quartet
    splits exactly (two equal pairs, different across); it *supports* the
    reference if the equal pairs are (a,b) and (c,d).

    Returns (scf (n_anc,), mean decisive sites (n_anc,)); NaN where no
    internal edge is defined.
    """
    rng = np.random.default_rng(seed)
    seqs = np.asarray(leaf_sequences)
    if sequences_are_masks:
        single = (seqs & (seqs - 1)) == 0  # one-bit masks are unambiguous
        valid = single & (seqs != 0)
    else:
        valid = seqs >= 0
    weights = (
        np.ones(seqs.shape[1]) if site_weights is None
        else np.asarray(site_weights, dtype=np.float64)
    )

    n_anc = reference.n_leaves - 1
    scf = np.full(n_anc, np.nan)
    n_dec = np.full(n_anc, np.nan)
    for a, (ga, gb, gc, gd) in _internal_branches(reference):
        qa = rng.choice(ga, size=n_quartets)
        qb = rng.choice(gb, size=n_quartets)
        qc = rng.choice(gc, size=n_quartets)
        qd = rng.choice(gd, size=n_quartets)
        sa, sb, sc, sd = seqs[qa], seqs[qb], seqs[qc], seqs[qd]
        ok = valid[qa] & valid[qb] & valid[qc] & valid[qd]
        ab = sa == sb
        cd = sc == sd
        ac = sa == sc
        bd = sb == sd
        ad = sa == sd
        bc = sb == sc
        sup_ref = ok & ab & cd & ~ac
        sup_1 = ok & ac & bd & ~ab
        sup_2 = ok & ad & bc & ~ab
        decisive = (sup_ref | sup_1 | sup_2).astype(np.float64) * weights
        supporting = sup_ref.astype(np.float64) * weights
        dec_per_q = decisive.sum(axis=1)
        with np.errstate(invalid="ignore", divide="ignore"):
            frac = np.where(dec_per_q > 0, supporting.sum(axis=1) / dec_per_q,
                            np.nan)
        scf[a] = float(np.nanmean(frac)) if np.any(dec_per_q > 0) else np.nan
        n_dec[a] = float(dec_per_q.mean())
    return scf, n_dec


def concordance_factors(
    reference: Topology,
    gene_trees: list[Topology] | None = None,
    leaf_sequences: np.ndarray | None = None,
    *,
    n_quartets: int = 100,
    seed: int = 0,
    sequences_are_masks: bool = False,
    site_weights: np.ndarray | None = None,
) -> ConcordanceResult:
    """Compute gCF (needs ``gene_trees``) and/or sCF (needs an alignment)."""
    gcf = gcf_n = scf = scf_n = None
    if gene_trees is not None:
        gcf, gcf_n = gene_concordance(reference, gene_trees)
    if leaf_sequences is not None:
        scf, scf_n = site_concordance(
            reference, leaf_sequences, n_quartets=n_quartets, seed=seed,
            sequences_are_masks=sequences_are_masks,
            site_weights=site_weights,
        )
    return ConcordanceResult(gcf=gcf, gcf_n=gcf_n, scf=scf, scf_n=scf_n)
