"""The ('tree', 'site') mesh over the ranks of a ``torch.distributed`` world
(counterpart of ``trex_tpu/parallel/mesh.py``).

The engine's two parallel axes:

- ``tree``: the candidate-tree / restart batch — pure data parallelism;
  per-tree scores and topology gradients merge with a sum.
- ``site``: alignment sites — every objective is a sum over sites, so site
  shards compute partial scores that merge with one all-reduce.

JAX's mesh is one process driving N devices; here every rank runs the same
program on its own device and the collectives run on one process group per
row and column of the rank grid. Ranks are laid out row-major: rank
``r`` sits at ``(r // S, r % S)`` of a (T, S) mesh, as
``np.asarray(devices).reshape(T, S)`` lays out JAX's devices.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

TREE_AXIS = "tree"
SITE_AXIS = "site"


def mesh_shape(world_size: int, tree_parallelism: int | None = None) -> tuple[int, int]:
    """(T, S) of a mesh over ``world_size`` ranks. ``tree_parallelism``
    defaults to the JAX package's heuristic: the largest power of two T
    with T <= world_size / T that divides the world, so the mesh is about
    square."""
    if tree_parallelism is None:
        tree_parallelism = 1
        while (
            tree_parallelism * 2 <= world_size // (tree_parallelism * 2)
            and world_size % (tree_parallelism * 2) == 0
        ):
            tree_parallelism *= 2
    if world_size % tree_parallelism != 0:
        raise ValueError(f"{world_size} devices not divisible by tree={tree_parallelism}")
    return tree_parallelism, world_size // tree_parallelism


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of a (T, S) mesh: the shape, its own coordinates
    and one process group per axis (the row or column it sits in), or no
    groups in a process that never initialized ``torch.distributed``.

    ``psum``, ``all_gather`` and ``broadcast`` run over one axis. Over an
    axis of one rank without a group they are the identity, as a 1 x 1 JAX
    mesh's collectives are; over a longer axis without a group they raise.
    """

    shape: dict[str, int]
    """``{"tree": T, "site": S}``, as JAX's ``mesh.shape``."""
    tree_index: int
    site_index: int
    groups: dict[str, object | None]
    """The process group of each axis (None without ``torch.distributed``)."""
    ranks: dict[str, list[int]]
    """The global ranks along each axis, in axis order."""

    def _group(self, axis: str):
        group = self.groups[axis]
        if group is None and self.shape[axis] > 1:
            raise RuntimeError(
                f"the mesh's {axis!r} axis spans {self.shape[axis]} ranks, but this "
                "process has not joined a torch.distributed world"
            )
        return group

    def psum(self, tensor: torch.Tensor, axis: str) -> torch.Tensor:
        """The sum of ``tensor`` over ``axis``, in place; returns it."""
        group = self._group(axis)
        if group is not None:
            dist.all_reduce(tensor, op=dist.ReduceOp.SUM, group=group)
        return tensor

    def all_gather(self, tensor: torch.Tensor, axis: str) -> torch.Tensor:
        """(k, *tensor.shape): every rank's ``tensor`` along ``axis``, in
        axis order (the list form of ``all_gather``, which gloo has on the
        CPU and the card)."""
        group = self._group(axis)
        if group is None:
            return tensor[None]
        tensor = tensor.contiguous()
        parts = [torch.empty_like(tensor) for _ in range(self.shape[axis])]
        dist.all_gather(parts, tensor, group=group)
        return torch.stack(parts)

    def broadcast(self, tensor: torch.Tensor, axis: str, source: int) -> torch.Tensor:
        """``tensor`` of the rank at coordinate ``source`` along ``axis``,
        written in place on every rank of the axis; returns it."""
        group = self._group(axis)
        if group is not None:
            dist.broadcast(tensor, src=self.ranks[axis][source], group=group)
        return tensor


def local_mesh() -> Mesh:
    """The 1 x 1 mesh of this rank alone, with no groups (its collectives
    are the identity), in or out of a world: the single-device runs of the
    sharded paths."""
    rank = dist.get_rank() if dist.is_available() and dist.is_initialized() else 0
    return Mesh(shape={TREE_AXIS: 1, SITE_AXIS: 1}, tree_index=0, site_index=0,
                groups={TREE_AXIS: None, SITE_AXIS: None},
                ranks={TREE_AXIS: [rank], SITE_AXIS: [rank]})


def is_output_rank(mesh: Mesh | None = None) -> bool:
    """True on the one rank that prints and writes files: the rank at
    coordinate (0, 0) of ``mesh`` (whose ranks all hold what is written),
    or with no mesh that of the world's (``make_mesh`` lays ranks out
    row-major: rank 0), or the only process."""
    if mesh is not None:
        return mesh.tree_index == 0 and mesh.site_index == 0
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def make_mesh(world_size: int | None = None, tree_parallelism: int | None = None) -> Mesh:
    """Build the ('tree', 'site') mesh of this rank.

    Args:
        world_size: the ranks the mesh spans; defaults to the world's size
            (1 in a process that never initialized ``torch.distributed``).
            In a world it must be the world's size.
        tree_parallelism: size of the tree axis; default ``mesh_shape``'s
            heuristic.

    In a world, every rank must call this with the same arguments and in the
    same order as its other group creations: it creates a group for every
    row and every column (``torch.distributed.new_group``), as the backend
    requires. Without a world the mesh has no groups; its collectives are
    the identity on axes of one rank.
    """
    joined = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if joined else 1
    if world_size is None:
        world_size = world
    elif joined and world_size != world:
        raise ValueError(f"a mesh of {world_size} ranks in a world of {world}")
    n_tree, n_site = mesh_shape(world_size, tree_parallelism)
    rank = dist.get_rank() if joined else 0
    tree_index, site_index = divmod(rank, n_site)
    rows = [[t * n_site + s for s in range(n_site)] for t in range(n_tree)]
    cols = [[t * n_site + s for t in range(n_tree)] for s in range(n_site)]
    groups: dict[str, object | None] = {TREE_AXIS: None, SITE_AXIS: None}
    if joined:
        for t, ranks in enumerate(rows):
            group = dist.new_group(ranks)
            if t == tree_index:
                groups[SITE_AXIS] = group
        for s, ranks in enumerate(cols):
            group = dist.new_group(ranks)
            if s == site_index:
                groups[TREE_AXIS] = group
    return Mesh(
        shape={TREE_AXIS: n_tree, SITE_AXIS: n_site},
        tree_index=tree_index, site_index=site_index, groups=groups,
        ranks={TREE_AXIS: cols[site_index], SITE_AXIS: rows[tree_index]},
    )
