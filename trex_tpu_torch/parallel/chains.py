"""The samplers' chain axis over the mesh's ``tree`` axis (counterpart of the
``PartitionSpec('tree')`` layout the JAX package gives the chain and rung
arrays of ``search/mcmc.py``, ``search/dating.py`` and
``search/marginal.py``).

Rank t of a (T, S) mesh holds rows t * n / T .. (t + 1) * n / T - 1 of an
n-row chain batch, in axis order; the ``site`` axis replicates them (its
ranks hold the same chains and compute the same values), as JAX replicates
the sampler state over ``site``. Every float operation of a generation is
per chain, so a rank's rows follow the single-device trajectory; what
crosses ranks is integer counters (``psum_counts``), the gathered rows of
a collective step or a host boundary (``gather_rows``, ``gather_packed``)
and, under ``mesh_barrier``, the end of a file write.

On a 1 x 1 mesh (``parallel.mesh.local_mesh``) every function here is the
identity, with no copy.
"""

from __future__ import annotations

import torch

from trex_tpu_torch.parallel.mesh import SITE_AXIS, TREE_AXIS, Mesh


def chain_rows(mesh: Mesh, n: int, what: str) -> slice:
    """This rank's contiguous rows of an ``n``-row batch over ``tree``.
    ``what`` names ``n`` in the error when the axis does not divide it (the
    JAX samplers' message: ``"n_rungs = 6 must be divisible by the mesh
    tree axis size (4)"``)."""
    n_tree = mesh.shape[TREE_AXIS]
    if n % n_tree:
        raise ValueError(f"{what} = {n} must be divisible by the mesh tree axis size ({n_tree})")
    size = n // n_tree
    return slice(mesh.tree_index * size, (mesh.tree_index + 1) * size)


def gather_rows(mesh: Mesh, local: torch.Tensor) -> torch.Tensor:
    """The whole batch of every rank's ``local`` rows (axis 0), gathered
    over ``tree`` in axis order: one ``all_gather``."""
    if mesh.shape[TREE_AXIS] == 1:
        return local
    return mesh.all_gather(local, TREE_AXIS).flatten(0, 1)


def gather_packed(mesh: Mesh, tensors) -> list[torch.Tensor]:
    """``gather_rows`` of several float32 or int32 tensors with the same
    rows (axis 0) in one collective: side by side as float32 bits (an
    int32 is viewed, not converted), gathered, then split."""
    tensors = list(tensors)
    if mesh.shape[TREE_AXIS] == 1:
        return tensors
    rows = tensors[0].shape[0]
    flat = [t.reshape(rows, -1) for t in tensors]
    whole = gather_rows(mesh, torch.cat(
        [f.view(torch.float32) if f.dtype == torch.int32 else f for f in flat], dim=1))
    out, at = [], 0
    for t, f in zip(tensors, flat):
        part = whole[:, at:at + f.shape[1]].contiguous()
        at += f.shape[1]
        if t.dtype == torch.int32:
            part = part.view(torch.int32)
        out.append(part.reshape(-1, *t.shape[1:]))
    return out


def psum_counts(mesh: Mesh, counts: torch.Tensor) -> torch.Tensor:
    """The batch's integer counters: each rank's ``counts`` (of its own
    rows) summed over ``tree``, in a new tensor."""
    return mesh.psum(counts.clone(), TREE_AXIS)


def mesh_barrier(mesh: Mesh, device) -> None:
    """Return on every rank of the mesh only once every rank has called it
    (a sum over ``tree``, then over ``site``, read back on the host: on
    NCCL the sums alone only order streams): after the writer's file is on
    disk, no rank reads it early."""
    token = torch.ones((1,), device=device)
    mesh.psum(token, TREE_AXIS)
    mesh.psum(token, SITE_AXIS)
    token.item()
