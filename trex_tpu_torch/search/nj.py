"""Distance trees: neighbor joining and UPGMA (counterpart of
``trex_tpu/search/nj.py``).

The distance matrices come from the device (``ops.distances``, one float32
product; a bootstrap's replicates in one batched call); the agglomeration
is host numpy in float64: it runs once, is branchy, and its argmin scans
are O(n^2) a join.

Output is a rooted binary ``Topology`` in the canonical numbering (leaves
first, ancestors in join order, root last): each join makes the next
ancestor from two smaller active indices, so index order is topological.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from trex_tpu_torch.topology import Topology, from_numpy


def _host(distances) -> np.ndarray:
    if torch.is_tensor(distances):
        distances = distances.cpu().numpy()
    return np.asarray(distances, dtype=np.float64)


def neighbor_joining(distances, device="cpu") -> tuple[Topology, np.ndarray]:
    """Saitou-Nei neighbor joining, rooted at the final join.

    Args:
        distances: (n, n) symmetric distance matrix (host or device).
        device: where the returned topology's tensors live.

    Returns (topology over 2n - 1 nodes, (2n - 1,) float64 branch lengths
    indexed by child node, the root's 0). Negative NJ estimates are kept.
    """
    d0 = _host(distances)
    n_leaves = d0.shape[0]
    if d0.shape != (n_leaves, n_leaves):
        raise ValueError(f"distances must be square, got {d0.shape}")
    if n_leaves < 2:
        raise ValueError("need at least 2 taxa")
    n_all = 2 * n_leaves - 1

    children = np.zeros((n_leaves - 1, 2), dtype=np.int32)
    parents = np.zeros((n_all,), dtype=np.int32)
    parents[-1] = n_all - 1
    blens = np.zeros((n_all,), dtype=np.float64)

    # The active rows and the node each row stands for.
    d = d0.copy()
    ids = np.arange(n_leaves, dtype=np.int32)

    for a in range(n_leaves - 1):
        r = d.shape[0]
        if r > 2:
            row_sums = d.sum(axis=1)
            q = (r - 2) * d - row_sums[:, None] - row_sums[None, :]
            np.fill_diagonal(q, np.inf)
            i, j = np.unravel_index(np.argmin(q), q.shape)
            if i > j:
                i, j = j, i
            dij = d[i, j]
            bl_i = 0.5 * dij + (row_sums[i] - row_sums[j]) / (2.0 * (r - 2))
            bl_j = dij - bl_i
            new_row = 0.5 * (d[i] + d[j] - dij)
        else:
            i, j = 0, 1
            dij = d[0, 1]
            bl_i = bl_j = 0.5 * dij
            new_row = np.zeros((2,))

        node = n_leaves + a
        # ids stays sorted (new nodes take the largest index), so i < j
        # gives ascending children.
        children[a] = (int(ids[i]), int(ids[j]))
        parents[ids[i]] = node
        parents[ids[j]] = node
        blens[ids[i]] = bl_i
        blens[ids[j]] = bl_j
        keep = np.delete(np.arange(r), [i, j])
        nd = np.empty((r - 1, r - 1))
        nd[:-1, :-1] = d[np.ix_(keep, keep)]
        nd[-1, :-1] = new_row[keep]
        nd[:-1, -1] = new_row[keep]
        nd[-1, -1] = 0.0
        d = nd
        ids = np.append(ids[keep], np.int32(node))

    return from_numpy(children, parents, device), blens


def upgma(distances, device="cpu") -> tuple[Topology, np.ndarray]:
    """UPGMA average-linkage clustering (a molecular clock). Same output as
    ``neighbor_joining``; exact on ultrametric matrices."""
    d0 = _host(distances)
    n_leaves = d0.shape[0]
    if n_leaves < 2:
        raise ValueError("need at least 2 taxa")
    n_all = 2 * n_leaves - 1

    children = np.zeros((n_leaves - 1, 2), dtype=np.int32)
    parents = np.zeros((n_all,), dtype=np.int32)
    parents[-1] = n_all - 1
    blens = np.zeros((n_all,), dtype=np.float64)
    heights = np.zeros((n_all,), dtype=np.float64)

    d = d0.copy()
    np.fill_diagonal(d, np.inf)
    ids = np.arange(n_leaves, dtype=np.int32)
    sizes = np.ones((n_leaves,), dtype=np.float64)

    for a in range(n_leaves - 1):
        i, j = np.unravel_index(np.argmin(d), d.shape)
        if i > j:
            i, j = j, i
        node = n_leaves + a
        height = 0.5 * d[i, j]
        children[a] = (int(ids[i]), int(ids[j]))
        parents[ids[i]] = node
        parents[ids[j]] = node
        heights[node] = height
        blens[ids[i]] = height - heights[ids[i]]
        blens[ids[j]] = height - heights[ids[j]]
        # Size-weighted average linkage.
        new_row = (sizes[i] * d[i] + sizes[j] * d[j]) / (sizes[i] + sizes[j])
        keep = np.delete(np.arange(d.shape[0]), [i, j])
        r = keep.size + 1
        nd = np.full((r, r), np.inf)
        nd[:-1, :-1] = d[np.ix_(keep, keep)]
        nd[-1, :-1] = new_row[keep]
        nd[:-1, -1] = new_row[keep]
        d = nd
        sizes = np.append(sizes[keep], sizes[i] + sizes[j])
        ids = np.append(ids[keep], np.int32(node))

    return from_numpy(children, parents, device), blens


_BUILDERS = {"nj": neighbor_joining, "upgma": upgma}


def _distance_fn(correction: str):
    from trex_tpu_torch.ops.distances import jc_distance_matrix, p_distance_matrix

    return {"jc": jc_distance_matrix, "p": p_distance_matrix}[correction]


def _device_of(leaf_sequences, device) -> torch.device:
    from trex_tpu_torch._device import resolve_device

    if device is None and torch.is_tensor(leaf_sequences):
        device = leaf_sequences.device
    return resolve_device("cuda" if device is None else device)


def nj_start_tree(
    leaf_sequences,
    n_states: int,
    site_weights=None,
    *,
    method: str = "nj",
    correction: str = "jc",
    device=None,
) -> tuple[Topology, np.ndarray]:
    """Distance tree of an alignment: the matrix on ``device`` (default the
    device of a tensor ``leaf_sequences``, else ``cuda``), the
    agglomeration on the host.

    Args:
        leaf_sequences: (n, L) integer states.
        method: "nj" (default) or "upgma".
        correction: "jc" (Jukes-Cantor, default) or "p" (raw proportion).
    """
    device = _device_of(leaf_sequences, device)
    d = _distance_fn(correction)(
        torch.as_tensor(leaf_sequences, device=device), n_states,
        None if site_weights is None else torch.as_tensor(site_weights, device=device))
    return _BUILDERS[method](d.cpu().numpy(), device)


def nj_bootstrap(
    leaf_sequences,
    n_states: int,
    *,
    n_replicates: int = 100,
    method: str = "nj",
    correction: str = "jc",
    site_weights=None,
    replicate_weights=None,
    generator: torch.Generator | None = None,
    device=None,
    timings: dict | None = None,
) -> tuple[Topology, np.ndarray, np.ndarray]:
    """Distance-tree bootstrap: the support of each split of the NJ/UPGMA
    tree.

    The replicates' weights are ``replicate_weights`` ((R, L) counts, the
    JAX package's draws replayed) or else drawn from ``generator``
    (``search.bootstrap._replicate_weights``: pattern occurrences
    resampled, the base weights ``site_weights`` or ones). All R distance
    matrices come from one batched device call; the host agglomerates each
    replicate and counts which reference splits it keeps. ``timings``: a
    dict that, when given, receives the wall seconds of the reference tree
    (``"reference"``), the replicates' matrices (``"distances"``, after
    the device is done) and their agglomeration (``"agglomerate"``).

    Returns (reference topology, branch lengths, support (n_ancestors,) in
    [0, 1]; trivial splits get 1.0).
    """
    from trex_tpu_torch.search.bootstrap import _replicate_weights, subtree_leaf_sets

    device = _device_of(leaf_sequences, device)
    seqs = torch.as_tensor(leaf_sequences, device=device)
    build = _BUILDERS[method]
    t0 = time.perf_counter()
    ref_topo, blens = nj_start_tree(seqs, n_states, site_weights, method=method,
                                    correction=correction, device=device)
    n_leaves = ref_topo.n_leaves
    every = frozenset(range(n_leaves))

    def norm(clade):
        side = every - clade if 0 in clade else clade
        return side if 1 < len(side) < n_leaves - 1 else None

    ref_norm = [norm(clade) for clade in subtree_leaf_sets(ref_topo)]
    length = seqs.shape[-1]
    if replicate_weights is None:
        if generator is None:
            raise ValueError("nj_bootstrap needs replicate_weights or a generator")
        base = (torch.ones((length,), dtype=torch.float32) if site_weights is None
                else torch.as_tensor(site_weights, dtype=torch.float32))
        replicate_weights = _replicate_weights(length, n_replicates, base, generator)
    rep_w = torch.as_tensor(replicate_weights, device=device)[:n_replicates].to(torch.float32)
    t1 = time.perf_counter()
    dists = _distance_fn(correction)(seqs, n_states, rep_w).cpu().numpy()  # (R, n, n)
    t2 = time.perf_counter()

    counts = np.zeros((len(ref_norm),))
    for r in range(n_replicates):
        topo_r, _ = build(dists[r])
        splits_r = {s for s in map(norm, subtree_leaf_sets(topo_r)) if s is not None}
        for i, split in enumerate(ref_norm):
            if split is not None and split in splits_r:
                counts[i] += 1
    support = counts / float(n_replicates)
    for i, split in enumerate(ref_norm):
        if split is None:
            support[i] = 1.0
    if timings is not None:
        timings.update(reference=t1 - t0, distances=t2 - t1,
                       agglomerate=time.perf_counter() - t2)
    return ref_topo, blens, support
