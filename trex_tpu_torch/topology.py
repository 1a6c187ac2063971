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
