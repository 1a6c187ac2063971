"""Majority-rule consensus trees from replicate topologies (counterpart of
``trex_tpu/search/consensus.py``).

Splits in more than ``threshold`` of the input trees are pairwise
compatible and nest into a (possibly multifurcating) consensus tree. Host
Python: analysis, not compute path.
"""

from __future__ import annotations

from trex_tpu_torch.search.bootstrap import subtree_leaf_sets
from trex_tpu_torch.topology import Topology, from_numpy


def split_frequencies(trees: list[Topology]) -> dict[frozenset[int], float]:
    """Fraction of input trees containing each observed split."""
    counts: dict[frozenset[int], int] = {}
    for topo in trees:
        for split in set(subtree_leaf_sets(topo)):
            counts[split] = counts.get(split, 0) + 1
    n = max(len(trees), 1)
    return {s: c / n for s, c in counts.items()}


def majority_rule_consensus(
    trees: list[Topology],
    leaf_names: list[str] | None = None,
    threshold: float = 0.5,
) -> tuple[str, list[tuple[frozenset[int], float]]]:
    """Build the majority-rule consensus of replicate trees.

    Returns:
        newick: consensus tree with per-clade support values as internal
            labels (polytomies allowed, so this does not round-trip through
            the binary ``Topology`` type).
        kept: (split, support) pairs, largest split (root) first.
    """
    if not trees:
        raise ValueError("no input trees")
    n_leaves = trees[0].n_leaves
    freqs = split_frequencies(trees)
    all_leaves = frozenset(range(n_leaves))
    kept = {s: f for s, f in freqs.items() if f > threshold and len(s) > 1}
    kept[all_leaves] = 1.0  # root always present

    # Nest splits: parent = smallest kept split strictly containing it.
    ordered = sorted(kept, key=len)
    children: dict[frozenset[int], list] = {s: [] for s in kept}
    direct_leaves: dict[frozenset[int], set[int]] = {s: set(s) for s in kept}
    for i, s in enumerate(ordered):
        if s == all_leaves:
            continue
        parent = min(
            (t for t in ordered[i + 1 :] if s < t),
            key=len,
        )
        children[parent].append(s)
        direct_leaves[parent] -= s

    names = leaf_names or [f"L{i}" for i in range(n_leaves)]

    def render(split: frozenset[int]) -> str:
        parts = [render(c) for c in sorted(children[split], key=min)]
        parts += [names[i] for i in sorted(direct_leaves[split])]
        label = "" if split == all_leaves else f"{kept[split]:.2f}"
        return "(" + ",".join(parts) + ")" + label

    newick = render(all_leaves) + ";"
    kept_sorted = sorted(kept.items(), key=lambda kv: -len(kv[0]))
    return newick, kept_sorted


def consensus_topology(
    trees: list[Topology], threshold: float = 0.5
) -> Topology | None:
    """Majority-rule consensus as a ``Topology`` when fully resolved.

    Returns None when the consensus contains polytomies (fewer than
    ``n_leaves - 1`` majority splits) — use ``majority_rule_consensus`` for
    the general (newick) form.
    """
    from trex_tpu_torch.io.fallback import _canonicalize

    n_leaves = trees[0].n_leaves
    freqs = split_frequencies(trees)
    all_leaves = frozenset(range(n_leaves))
    kept = [s for s, f in freqs.items() if f > threshold and len(s) > 1]
    if all_leaves not in kept:
        kept.append(all_leaves)
    if len(kept) != n_leaves - 1:
        return None
    # Nest splits into a binary tree: each split's node joins its two kept
    # children (splits or single leaves).
    ordered = sorted(kept, key=len)
    tmp_of_split = {s: n_leaves + i for i, s in enumerate(ordered)}
    kids: dict[int, list[int]] = {tmp_of_split[s]: [] for s in ordered}
    direct: dict[frozenset, set[int]] = {s: set(s) for s in ordered}
    for i, s in enumerate(ordered[:-1]):
        parent = min((t for t in ordered[i + 1 :] if s < t), key=len)
        kids[tmp_of_split[parent]].append(tmp_of_split[s])
        direct[parent] -= s
    for s in ordered:
        kids[tmp_of_split[s]].extend(sorted(direct[s]))
    if any(len(v) != 2 for v in kids.values()):
        return None
    children, parents, _ = _canonicalize(
        n_leaves, kids, tmp_of_split[all_leaves]
    )
    return from_numpy(children, parents)
