"""SPR-decay (approximate Bremer) support from the analytic SPR scan
(counterpart of ``trex_tpu/search/bremer.py``).

The Bremer support of an internal branch is the extra parsimony steps the
best tree without that split needs. The SPR-decay bound (PAUP*'s) looks
for that tree within the SPR neighborhood: an SPR move destroys exactly
the splits on the path between its prune edge and its regraft edge, so

    decay[e]  <=  min over moves destroying e of (move score - best score),

and the whole bound comes from one ``ops.spr_scan`` table plus host path
walks; each edge's minimum is then verified by applying the move and
comparing split sets. The moves are visited in ascending score with their
paths walked lazily, so the walk stops once every split has its value
(the JAX package walks every finite move's path first).
"""

from __future__ import annotations

import numpy as np

from trex_tpu_torch.topology import Topology


def spr_decay_support(
    topology: Topology,
    leaf_sequences,
    site_weights=None,
    *,
    sequences_are_masks: bool = False,
    device=None,
    mesh=None,
) -> tuple[np.ndarray, float]:
    """(n_ancestors,) SPR-decay values of the internal branches and the
    base score.

    Entries are upper bounds on the Bremer support, in parsimony steps;
    the root's entry and branches no move of the neighborhood destroys
    are NaN. The scan (the full table, ``parallel.sharded.sharded_spr_scan``,
    segmented and chunked as the SPR-scan climb's) runs on ``device``: by
    default that of ``leaf_sequences`` when it is a tensor, else ``cuda``.
    With ``mesh`` (a ('tree', 'site') ``parallel.mesh.Mesh``; every rank
    calls with the same inputs; None: this device alone) the scan's prune
    rows split over ``tree`` and the table is gathered: the decay needs the
    whole table.
    """
    import torch

    from trex_tpu_torch._device import resolve_device
    from trex_tpu_torch.io import spr_move
    from trex_tpu_torch.parallel.sharded import sharded_spr_scan
    from trex_tpu_torch.search.bootstrap import subtree_leaf_sets
    from trex_tpu_torch.search.ratchet import unrooted_splits

    if device is None and torch.is_tensor(leaf_sequences):
        device = leaf_sequences.device
    device = resolve_device("cuda" if device is None else device)
    leaves = torch.as_tensor(leaf_sequences, device=device)
    topology = topology.to(device)
    n_leaves = topology.n_leaves
    n_all = topology.n_all
    _, parents = topology.to_numpy()
    scores, base = sharded_spr_scan(mesh, topology, leaves, site_weights,
                                    sequences_are_masks=sequences_are_masks)
    scores = scores.cpu().numpy().astype(np.float64)
    base = float(base)

    depth = np.zeros(n_all, np.int32)
    for node in range(n_all - 2, -1, -1):
        depth[node] = depth[parents[node]] + 1

    def path_edges(a: int, b: int) -> list[int]:
        """The edges (each named by the node below it) whose splits an SPR
        from junction ``a`` to the edge above ``b`` destroys: every edge
        crossed on the a..b path (a's own when the path climbs through it,
        the first edge below a when it descends), but not the regraft edge
        above ``b``, which the insertion only subdivides."""
        edges = []
        x, y = a, b
        while x != y:
            if depth[x] >= depth[y]:
                edges.append(x)
                x = parents[x]
            else:
                edges.append(y)
                y = parents[y]
        return [e for e in edges if e != b]

    every = frozenset(range(n_leaves))
    ref_sides: list[frozenset | None] = []
    for clade in subtree_leaf_sets(topology):
        side = every - clade if 0 in clade else clade
        ref_sides.append(side if 1 < len(side) < n_leaves - 1 else None)

    # Every finite move in ascending delta (ties in prune-major,
    # regraft-minor order, as a stable sort of the table's rows gives). The
    # path rule may claim a split that a move merely re-roots, so each
    # edge's minimum is verified by applying the move; the paths are walked
    # lazily, only until every split has its value.
    p_idx, v_idx = np.nonzero(np.isfinite(scores))
    delta = scores[p_idx, v_idx] - base
    order = np.lexsort((v_idx, p_idx, delta))

    decay = np.full((topology.n_ancestors,), np.nan)
    unset = {i for i in range(topology.n_ancestors) if ref_sides[i] is not None}
    for k in order.tolist():
        if not unset:
            break
        p, v = int(p_idx[k]), int(v_idx[k])
        pending = [
            e - n_leaves for e in path_edges(int(parents[p]), v)
            if e >= n_leaves and (e - n_leaves) in unset
        ]
        if not pending:
            continue
        moved = spr_move(topology, p, v)
        if moved is None:
            continue
        moved_splits = unrooted_splits(moved)
        for i in pending:
            if ref_sides[i] not in moved_splits:
                decay[i] = float(delta[k])
                unset.discard(i)
    return decay, base
