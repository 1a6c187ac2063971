"""Device-side NNI rearrangements for the samplers (counterpart of
``trex_tpu/ops/tree_moves.py``).

Every function takes a leading chain axis: ``children`` (C, n_anc, 2),
``lengths`` (C, n_all), one edge and variant a chain. An NNI at the
internal edge above ancestor M = n_leaves + edge is a pointer swap: M's
sibling and one of M's children exchange parents, and every other subtree
keeps its slot, so branch lengths carry across the move by index (the one
changed clade keeps M's slot and its length). The swap can put a child
above its parent in index order; ``_nni_apply`` restores the order with a
cyclic shift of the ancestor slots between M and its old sibling, and
``renumber_topological`` renumbers any valid tree from node heights.

The numbering is valid (children below parents, root last) but not the
structure-determined canonical one of ``io.canonicalize_topology``; it is
the JAX package's numbering integer for integer, since the samplers' chain
states carry it. Gathers and scatters only: no host sync.
"""

from __future__ import annotations

import torch

from trex_tpu_torch.ops.likelihood import highest_matmul_precision


def parents_from_children(children: torch.Tensor, n_leaves: int) -> torch.Tensor:
    """(C, n_all) int64 parent of each node (the root its own parent)."""
    batch, n_anc, _ = children.shape
    n_all = n_leaves + n_anc
    kids = children.long()
    anc = torch.arange(n_leaves, n_all, device=children.device).expand(batch, n_anc)
    parents = torch.zeros((batch, n_all), dtype=torch.int64, device=children.device)
    parents.scatter_(1, kids[..., 0], anc)
    parents.scatter_(1, kids[..., 1], anc)
    parents[:, -1] = n_all - 1
    return parents


def _relabel(children: torch.Tensor, order: torch.Tensor, inv: torch.Tensor,
             n_leaves: int) -> torch.Tensor:
    """Ancestor rows taken in ``order`` (new slot j holds old offset
    order[j]), their nodes renamed by ``inv`` (old offset -> new), each pair
    ascending; int32."""
    batch, n_anc, _ = children.shape
    leaves = torch.arange(n_leaves, device=children.device).expand(batch, n_leaves)
    node_map = torch.cat([leaves, n_leaves + inv], dim=1)
    rows = children.gather(1, order[..., None].expand(batch, n_anc, 2))
    renamed = node_map.gather(1, rows.reshape(batch, -1)).view(batch, n_anc, 2)
    return torch.sort(renamed, dim=-1).values.to(torch.int32)


@highest_matmul_precision
def ancestor_matrix(children: torch.Tensor, n_leaves: int) -> torch.Tensor:
    """(C, n_all, n_all) float32 0/1 matrix A of trees given by children
    (C, n_anc, 2) in any ancestor numbering: A[u, v] = 1 when v is u or
    lies on the path from u to the root.

    The closure of the parent relation by ceil(log2(n_all)) squarings, each
    clamped to 0/1: a fixed number of batched products, where a walk up
    the tree would take its height in steps. Exact in float32 (the
    products count at most n_all paths).
    """
    batch, n_anc, _ = children.shape
    n_all = n_leaves + n_anc
    device = children.device
    parents = parents_from_children(children, n_leaves)
    up = torch.zeros((batch, n_all, n_all), dtype=torch.float32, device=device)
    up.scatter_(2, parents[..., None], 1.0)
    up = torch.clamp(up + torch.eye(n_all, device=device), max=1.0)
    for _ in range(max(1, (n_all - 1).bit_length())):
        up = torch.clamp(torch.matmul(up, up), max=1.0)
    return up


def subtree_heights(children: torch.Tensor, n_leaves: int) -> torch.Tensor:
    """(C, n_all) int64 height of every node (leaves 0, an ancestor one
    above its higher child) of valid trees whose ancestor numbering may
    break index order: a node's depth is its ``ancestor_matrix`` row sum
    less one, and its height the greatest depth below it less its own, in
    a fixed number of batched products where the reference sweeps its
    n_anc ancestors n_anc times."""
    up = ancestor_matrix(children, n_leaves)
    depth = up.sum(dim=2) - 1.0
    deepest = torch.amax(up * (depth[:, :, None] + 1.0), dim=1) - 1.0
    return (deepest - depth).round().long()


def renumber_topological(
    children: torch.Tensor, n_leaves: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Renumber the ancestors of valid rooted binary trees (root at the last
    index) so every child sits below its parent.

    Returns ``(new_children (C, n_anc, 2) int32, order (C, n_anc) int64)``:
    new slot j holds old ancestor offset order[j] (a payload follows by
    ``payload[n_leaves + order]``). Ancestors sort by height, ties by old
    index (a stable argsort), exactly as the reference's.
    """
    heights = subtree_heights(children, n_leaves)
    order = torch.argsort(heights[:, n_leaves:], dim=1, stable=True)
    batch, n_anc = order.shape
    inv = torch.empty_like(order).scatter_(
        1, order, torch.arange(n_anc, device=order.device).expand(batch, n_anc))
    return _relabel(children.long(), order, inv, n_leaves), order


def _nni_apply(children: torch.Tensor, lengths: torch.Tensor, parents: torch.Tensor,
               edge: torch.Tensor, variant: torch.Tensor, n_leaves: int):
    """Pointer-swap NNI of each row and the cyclic-shift renumber of its
    ancestor offsets [edge, old sibling offset] (the identity when the
    sibling is a leaf or lies below M); ``children`` int64, ``parents`` from
    ``parents_from_children``. Returns (children int32, lengths)."""
    batch, n_anc, _ = children.shape
    rows = torch.arange(batch, device=children.device)
    edge = edge.long()
    m_node = n_leaves + edge
    p_off = parents[rows, m_node] - n_leaves
    p_kids = children[rows, p_off]
    sib = torch.where(p_kids[:, 0] == m_node, p_kids[:, 1], p_kids[:, 0])
    m_kids = children[rows, edge]
    first = variant.long() == 0
    grand = torch.where(first, m_kids[:, 0], m_kids[:, 1])
    kept = torch.where(first, m_kids[:, 1], m_kids[:, 0])
    swapped = children.clone()
    swapped[rows, p_off] = torch.stack([m_node, grand], dim=1)
    swapped[rows, edge] = torch.stack([sib, kept], dim=1)
    oc = edge[:, None]
    os_ = torch.where(sib - n_leaves > edge, sib - n_leaves, edge)[:, None]
    j = torch.arange(n_anc, device=children.device)[None, :]
    order = torch.where(j == os_, oc, torch.where((j >= oc) & (j < os_), j + 1, j))
    inv = torch.where(j == oc, os_, torch.where((j > oc) & (j <= os_), j - 1, j))
    new_lengths = torch.cat([lengths[:, :n_leaves], lengths.gather(1, n_leaves + order)], dim=1)
    return _relabel(swapped, order, inv, n_leaves), new_lengths


def nni_neighbor_device(
    children: torch.Tensor,
    lengths: torch.Tensor,
    edge: torch.Tensor,
    variant: torch.Tensor,
    n_leaves: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One NNI neighbour a chain: (children (C, n_anc, 2) int32, lengths
    (C, n_all)). ``edge`` (C,) picks the non-root ancestor M = n_leaves +
    edge, ``variant`` (C,) in {0, 1} which of M's children swaps with M's
    sibling; the 2 (n_leaves - 2) pairs make the host enumerator's move
    set."""
    parents = parents_from_children(children, n_leaves)
    return _nni_apply(children.long(), lengths, parents, edge, variant, n_leaves)


def nni_neighborhood_device(
    children: torch.Tensor, lengths: torch.Tensor, n_leaves: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """All K = 2 (n_leaves - 2) NNI neighbours of every chain: (children
    (C, K, n_anc, 2) int32, lengths (C, K, n_all)); neighbour 2 e + v is
    ``nni_neighbor_device(..., e, v)``."""
    batch, n_anc, _ = children.shape
    k = 2 * (n_anc - 1)
    device = children.device
    parents = parents_from_children(children, n_leaves)
    edges = torch.arange(n_anc - 1, device=device).repeat_interleave(2, output_size=k)
    variants = torch.arange(2, device=device).repeat(n_anc - 1)
    nbr_c, nbr_l = _nni_apply(
        children.long().repeat_interleave(k, dim=0, output_size=batch * k),
        lengths.repeat_interleave(k, dim=0, output_size=batch * k),
        parents.repeat_interleave(k, dim=0, output_size=batch * k),
        edges.repeat(batch), variants.repeat(batch), n_leaves,
    )
    return nbr_c.view(batch, k, n_anc, 2), nbr_l.view(batch, k, -1)
