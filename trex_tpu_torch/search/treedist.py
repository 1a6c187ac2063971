"""Branch-length-aware tree distance metrics (counterpart of
``trex_tpu/search/treedist.py``).

Complements the topology-only Robinson-Foulds machinery in
``search.ratchet`` with the standard weighted metrics (host-side numpy —
analysis, not compute-path):

- **branch-score distance** (Kuhner & Felsenstein 1994): sqrt of the sum of
  squared length differences over the union of splits (absent split = 0),
  pendant edges included;
- **weighted RF**: the same with |differences| (L1);
- **path-difference distance** (Steel & Penny 1993): Euclidean distance
  between the trees' patristic leaf-leaf distance matrices.

All metrics index splits by leaf NAME-independent leaf sets (the caller
must put both trees on one leaf numbering, e.g. ``io.renumber_leaves``).
"""

from __future__ import annotations

import numpy as np

from trex_tpu_torch.search.bootstrap import subtree_leaf_sets
from trex_tpu_torch.topology import Topology


def patristic_matrix(topology: Topology, lengths: np.ndarray) -> np.ndarray:
    """(n_leaves, n_leaves) sum of branch lengths along leaf-leaf paths.

    For each ancestor, every leaf pair split across its two child clades
    has that ancestor as LCA; distance = depth_i + depth_j - 2 depth_lca
    with depths measured from the root. O(n^2) host work.
    """
    lengths = np.asarray(lengths, dtype=np.float64)
    n_leaves = topology.n_leaves
    n_all = topology.n_all
    children, parents = topology.to_numpy()

    depth = np.zeros(n_all)
    for node in range(n_all - 2, -1, -1):  # parents have larger indices
        depth[node] = depth[parents[node]] + lengths[node]

    clades = [frozenset([i]) for i in range(n_leaves)]
    clades += subtree_leaf_sets(topology)
    out = np.zeros((n_leaves, n_leaves))
    for a in range(n_leaves - 1):
        lca = n_leaves + a
        left = sorted(clades[children[a, 0]])
        right = sorted(clades[children[a, 1]])
        for i in left:
            for j in right:
                d = depth[i] + depth[j] - 2 * depth[lca]
                out[i, j] = out[j, i] = d
    return out


def _split_lengths(
    topology: Topology, lengths: np.ndarray
) -> dict[frozenset[int], float]:
    """Length above each edge keyed by its (normalized) split leaf set.

    Pendant edges key by the singleton leaf set; internal edges by the
    side NOT containing leaf 0. The two root-child edges are one unrooted
    edge: their lengths are summed under one key.
    """
    lengths = np.asarray(lengths, dtype=np.float64)
    n_leaves = topology.n_leaves
    n_all = topology.n_all
    every = frozenset(range(n_leaves))
    clades = [frozenset([i]) for i in range(n_leaves)]
    clades += subtree_leaf_sets(topology)

    out: dict[frozenset[int], float] = {}
    for node in range(n_all - 1):
        s = clades[node]
        if 0 in s:
            s = every - s
        if not s or len(s) == n_leaves:
            continue
        out[s] = out.get(s, 0.0) + float(lengths[node])
    return out


def branch_score_distance(
    a: Topology, a_lengths: np.ndarray, b: Topology, b_lengths: np.ndarray
) -> float:
    """Kuhner-Felsenstein branch-score distance (L2 over the split union)."""
    sa = _split_lengths(a, a_lengths)
    sb = _split_lengths(b, b_lengths)
    total = 0.0
    for s in set(sa) | set(sb):
        d = sa.get(s, 0.0) - sb.get(s, 0.0)
        total += d * d
    return float(np.sqrt(total))


def weighted_rf_distance(
    a: Topology, a_lengths: np.ndarray, b: Topology, b_lengths: np.ndarray
) -> float:
    """Weighted Robinson-Foulds (L1 over the split union)."""
    sa = _split_lengths(a, a_lengths)
    sb = _split_lengths(b, b_lengths)
    return float(
        sum(abs(sa.get(s, 0.0) - sb.get(s, 0.0)) for s in set(sa) | set(sb))
    )


def path_difference_distance(
    a: Topology, a_lengths: np.ndarray, b: Topology, b_lengths: np.ndarray
) -> float:
    """Steel-Penny path-difference: ||patristic_a - patristic_b||_F over
    unordered leaf pairs."""
    da = patristic_matrix(a, a_lengths)
    db = patristic_matrix(b, b_lengths)
    diff = da - db
    iu = np.triu_indices(da.shape[0], 1)
    return float(np.sqrt(np.sum(diff[iu] ** 2)))
