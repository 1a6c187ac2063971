"""Struct-of-arrays tree topology (counterpart of ``trex_tpu/topology.py``).

A topology is two int32 tensors:

- ``children``: ``(..., n_ancestors, 2)`` — the two children of ancestor
  ``i`` (= tree node ``n_leaves + i``), ascending;
- ``parents``: ``(..., n_all)`` — parent of each node; the root points to
  itself.

Node-order contract: leaves ``0..n_leaves-1``, ancestors above, root last,
``n_all = 2 * n_leaves - 1``, and every child's index is below its
parent's, so visiting ancestors in index order is a valid post-order.
A batch of topologies is a leading axis on both tensors.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Topology:
    """A rooted binary tree over ``2 * n_leaves - 1`` indexed nodes."""

    children: torch.Tensor
    """(..., n_ancestors, 2) int32 — children of each ancestor node."""
    parents: torch.Tensor
    """(..., n_all) int32 — parent of each node; root maps to itself."""

    @property
    def n_ancestors(self) -> int:
        return self.children.shape[-2]

    @property
    def n_all(self) -> int:
        return self.parents.shape[-1]

    @property
    def n_leaves(self) -> int:
        return self.n_all - self.n_ancestors

    @property
    def device(self) -> torch.device:
        return self.children.device

    def to_numpy(self) -> tuple[np.ndarray, np.ndarray]:
        """Host int32 copies ``(children, parents)``."""
        return (
            self.children.cpu().numpy().astype(np.int32),
            self.parents.cpu().numpy().astype(np.int32),
        )

    def to(self, device) -> "Topology":
        return Topology(self.children.to(device), self.parents.to(device))


def from_numpy(children, parents, device="cpu") -> Topology:
    """``Topology`` from host arrays (e.g. a JAX topology's ``np.asarray``)."""
    return Topology(
        children=torch.as_tensor(
            np.ascontiguousarray(children, dtype=np.int32), device=device
        ),
        parents=torch.as_tensor(
            np.ascontiguousarray(parents, dtype=np.int32), device=device
        ),
    )


def balanced_topology(n_leaves: int, device="cpu") -> Topology:
    """Balanced binary tree in the reference's node numbering: ancestor
    ``i`` has children ``(2i, 2i + 1)``."""
    n_anc = n_leaves - 1
    n_all = n_leaves + n_anc
    nodes = np.arange(n_all - 1)
    parents = np.concatenate([n_leaves + nodes // 2, [n_all - 1]])
    anc = np.arange(n_anc)
    return from_numpy(np.stack([2 * anc, 2 * anc + 1], axis=1), parents, device)


def balanced_adjacency(n_leaves: int, dtype=torch.float32, device="cpu") -> torch.Tensor:
    """Dense adjacency of the balanced tree (A[child, parent] = 1)."""
    return topology_to_adjacency(balanced_topology(n_leaves, device), dtype=dtype)


def topology_from_adjacency(adjacency: torch.Tensor, n_leaves: int) -> Topology:
    """``Topology`` of a dense child->parent adjacency (``A[child, parent] =
    1``; a root self-loop is ignored). Each ancestor's children are its
    column's set rows in ascending order."""
    adjacency = torch.as_tensor(adjacency)
    n_all = adjacency.shape[-1]
    adj = adjacency.to(torch.float32) * (
        1.0 - torch.eye(n_all, dtype=torch.float32, device=adjacency.device)
    )
    idx = torch.arange(n_all, dtype=torch.int32, device=adjacency.device)
    masked = torch.where(adj[:, n_leaves:] > 0.5, idx[:, None], n_all)
    children = torch.sort(masked, dim=0).values[:2].T.to(torch.int32)
    has_parent = (adj > 0.5).any(dim=-1)
    parents = torch.where(has_parent, torch.argmax(adj, dim=-1).to(torch.int32), idx)
    return Topology(children.contiguous(), parents.to(torch.int32))


def topology_to_adjacency(topology: Topology, dtype=torch.float32) -> torch.Tensor:
    """Dense (n_all, n_all) adjacency with A[child, parent] = 1, no root loop."""
    n_all = topology.n_all
    device = topology.device
    adj = torch.zeros((n_all, n_all), dtype=dtype, device=device)
    child = torch.arange(n_all - 1, device=device)
    adj[child, topology.parents[:-1].long()] = 1
    return adj


def parents_to_topology(parents: torch.Tensor, n_leaves: int) -> Topology:
    """``Topology`` of a parent vector (root self-referential): the children
    of ancestor ``a`` are the two nodes whose parent is ``a``, ascending."""
    parents = torch.as_tensor(parents)
    n_all = parents.shape[-1]
    idx = torch.arange(n_all, dtype=torch.int32, device=parents.device)
    anc_ids = idx[n_leaves:]
    is_child = (parents[:, None] == anc_ids[None, :]) & (idx[:, None] != anc_ids[None, :])
    masked = torch.where(is_child, idx[:, None], n_all)
    children = torch.sort(masked, dim=0).values[:2].T.to(torch.int32)
    return Topology(children.contiguous(), parents.to(torch.int32))


def random_topologies(seed: int, n_leaves: int, batch: int, device="cpu") -> Topology:
    """``batch`` random rooted binary topologies (host-side, numpy).

    Coalescent-style: repeatedly join two uniformly random active lineages
    under the next fresh ancestor index. ``np.random.default_rng(seed)``
    draws exactly as the JAX package's ``random_topologies`` does with the
    last word of its key, so ``random_topologies(s, ...)`` equals its
    result for ``PRNGKey(s)``.
    """
    rng = np.random.default_rng(int(seed))
    n_anc = n_leaves - 1
    n_all = n_leaves + n_anc
    children = np.empty((batch, n_anc, 2), dtype=np.int32)
    parents = np.empty((batch, n_all), dtype=np.int32)
    for b in range(batch):
        active = list(range(n_leaves))
        for a in range(n_anc):
            i, j = rng.choice(len(active), size=2, replace=False)
            c1, c2 = active[i], active[j]
            lo, hi = (c1, c2) if c1 < c2 else (c2, c1)
            node = n_leaves + a
            children[b, a] = (lo, hi)
            parents[b, lo] = node
            parents[b, hi] = node
            active = [x for x in active if x not in (c1, c2)]
            active.append(node)
        parents[b, n_all - 1] = n_all - 1
    return from_numpy(children, parents, device)


def parents_from_children(children: np.ndarray) -> np.ndarray:
    """(n_all,) int32 parent vector of one host children array."""
    children = np.asarray(children)
    n_leaves = children.shape[0] + 1
    n_all = 2 * n_leaves - 1
    parents = np.empty((n_all,), dtype=np.int32)
    parents[-1] = n_all - 1
    rows = np.arange(n_leaves, n_all, dtype=np.int32)
    parents[children[:, 0]] = rows
    parents[children[:, 1]] = rows
    return parents
