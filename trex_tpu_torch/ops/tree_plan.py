"""The tree plan of the tree-DP kernels K5 and K3/K4: an evaluation order of
each tree's ancestors and a slot for each ancestor's row — the wrapper of
``csrc/tree_plan.cu`` and its plain numpy version.

A plan is a (B, n_anc, 4) int32 tensor of steps ``(v, src1, src2, dst)``:
evaluate ancestor ``v`` from its children ``children[v, 0]`` and
``children[v, 1]``, in that order, where ``src_k`` is the child's leaf index
(>= 0) or ``~slot`` (< 0) for the slot holding an ancestor child's row, and
put the row in slot ``dst``. The steps are a post-order that evaluates
first the child needing more slots (the first child on a tie), and a
node's row takes the slot of its first-evaluated ancestor child, or the
next free one; so the live rows form a stack of at most
``slots_for(n_leaves)`` = floor(log2 n_leaves) slots. The root is the last
step and its row is slot 0.

``tree_plan`` launches the kernel for CUDA tensors and runs
``tree_plan_plain`` for CPU tensors; its ``launches`` attribute counts the
grids it launches (one a call). Both give the same plan integer for
integer. ``slot_plan`` picks where the DP kernels keep their slots and how
many sites a block walks.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from trex_tpu_torch._device import device_limits
from trex_tpu_torch.ops import _nvcc

_MAX_TREES_PER_BLOCK = 4  # warps (trees) a block of the plan kernel
SITES_PER_BLOCK = (128, 64, 32)  # the DP kernels' block widths, widest first
_SM_SHARED = 233472  # shared memory of one SM (bytes); 1 KB of it is reserved per block
_BLOCK_RESERVED = 1024
_MAX_THREADS_PER_SM = 2048
_MAX_BLOCKS_PER_SM = 32


def slots_for(n_leaves: int) -> int:
    """The most slots a plan of an ``n_leaves`` tree uses: floor(log2 n),
    the largest Strahler number of a binary tree of n leaves."""
    if n_leaves < 2:
        raise ValueError(f"a tree plan needs at least 2 leaves, got {n_leaves}")
    return n_leaves.bit_length() - 1


def tree_bytes(n_anc: int) -> int:
    """Shared-memory bytes of one staged tree: children (int2) and one
    int32 word an ancestor (need and count, then depth and offset),
    rounded up to 16."""
    return (12 * n_anc + 15) // 16 * 16


@dataclasses.dataclass(frozen=True)
class PlanLaunch:
    """How the plan kernel runs: ``trees_per_block`` warps a block, one
    tree each, staged in ``smem_bytes`` of dynamic shared memory, or read
    from global memory with a global scratch (``staged`` False) where one
    tree does not fit."""

    trees_per_block: int
    staged: bool
    smem_bytes: int


def plan_launch(n_anc: int, smem_optin: int) -> PlanLaunch:
    per_tree = tree_bytes(n_anc)
    fit = smem_optin // per_tree
    if fit == 0:
        return PlanLaunch(_MAX_TREES_PER_BLOCK, False, 0)
    trees = min(_MAX_TREES_PER_BLOCK, fit)
    return PlanLaunch(trees, True, trees * per_tree)


@dataclasses.dataclass(frozen=True)
class SlotPlan:
    """Where a tree-DP kernel keeps its ``slots`` slot rows: ``"shared"``,
    a column per site in each block's dynamic shared memory, or
    ``"global"``, a buffer in global memory; blocks of ``sites_per_block``
    sites, ``threads_per_site`` threads each, with ``smem_bytes`` of
    dynamic shared memory, of which ``resident_threads`` fit on one SM;
    ``leaf_table``: the block tabulates its leaves' messages."""

    mode: str
    slots: int
    sites_per_block: int
    smem_bytes: int
    resident_threads: int
    threads_per_site: int = 1
    leaf_table: bool = False


def _resident_threads(smem_bytes: int, threads: int) -> int:
    blocks = min(_MAX_BLOCKS_PER_SM, _MAX_THREADS_PER_SM // threads,
                 _SM_SHARED // (smem_bytes + _BLOCK_RESERVED))
    return blocks * threads


def slot_plan(
    slots: int, column_bytes: int, fixed_bytes: int, smem_optin: int, *,
    widths: tuple[int, ...] = SITES_PER_BLOCK, threads_per_site: int = 1,
    max_threads: int = 128, global_column_bytes: int | None = None,
    leaf_table: bool = False,
) -> SlotPlan:
    """The block width and slot mode of a tree-DP kernel whose blocks hold
    ``fixed_bytes`` of shared memory (cost or transition matrix, leaf
    table) and ``column_bytes`` a site (its slot rows): the shared mode at
    the width of ``widths`` (``threads_per_site`` x sites at most
    ``max_threads``) that keeps the most threads resident on an SM, the
    widest on a tie. Where no width fits, the global mode at the widest
    width whose ``global_column_bytes`` a site fit (``None``: the kernel
    has no global mode, and ``ValueError``)."""
    widths = [s for s in widths if s * threads_per_site <= max_threads]
    best = None
    for sites in widths:
        smem = fixed_bytes + column_bytes * sites
        if smem > smem_optin:
            continue
        threads = _resident_threads(smem, sites * threads_per_site)
        if best is None or threads > best.resident_threads:
            best = SlotPlan("shared", slots, sites, smem, threads, threads_per_site, leaf_table)
    if best is not None:
        return best
    for sites in widths if global_column_bytes is not None else ():
        smem = fixed_bytes + global_column_bytes * sites
        if smem <= smem_optin:
            return SlotPlan("global", slots, sites, smem,
                            _resident_threads(smem, sites * threads_per_site),
                            threads_per_site, leaf_table)
    raise ValueError(
        f"tree-DP kernel: {slots} slots of {column_bytes} bytes a site beside "
        f"{fixed_bytes} bytes do not fit {smem_optin} bytes of shared memory"
    )


def tree_plan_plain(children: torch.Tensor) -> torch.Tensor:
    """(B, n_anc, 4) int32 plan of (B, n_anc, 2) children, in numpy (on
    the host, returned on the children's device): the kernel's two passes,
    vectorised over trees."""
    ch = children.detach().cpu().numpy().astype(np.int64)
    batch, n_anc, _ = ch.shape
    n_leaves = n_anc + 1
    rows = np.arange(batch)
    need = np.zeros((batch, n_anc + 1), np.int64)  # column n_anc: leaves
    count = np.zeros((batch, n_anc + 1), np.int64)
    inner = ch >= n_leaves
    idx = np.where(inner, ch - n_leaves, n_anc)  # a leaf reads the 0 column
    for a in range(n_anc):
        n1, n2 = need[rows, idx[:, a, 0]], need[rows, idx[:, a, 1]]
        need[:, a] = np.where(n1 == n2, n1 + 1, np.maximum(n1, n2))
        count[:, a] = count[rows, idx[:, a, 0]] + count[rows, idx[:, a, 1]] + 1
    plan = np.empty((batch, n_anc, 4), np.int64)
    offset = np.zeros_like(count)
    depth = np.zeros_like(need)
    for v in range(n_anc - 1, -1, -1):
        k1, k2 = idx[:, v, 0], idx[:, v, 1]
        i1, i2 = inner[:, v, 0], inner[:, v, 1]
        n1, n2 = need[rows, k1], need[rows, k2]
        s1, s2 = count[rows, k1], count[rows, k2]
        off, d = offset[:, v], depth[:, v]
        second = n2 > n1  # c2 evaluated first
        off1 = np.where(second, off + s2, off)
        off2 = np.where(second, off, off + s1)
        d1 = np.where(second, d + i2, d)
        d2 = np.where(second, d, d + i1)
        pos = off + s1 + s2
        plan[rows, pos] = np.stack(
            [np.full(batch, v), np.where(i1, ~d1, ch[:, v, 0]),
             np.where(i2, ~d2, ch[:, v, 1]), d], axis=1)
        offset[rows, k1], depth[rows, k1] = off1, d1
        offset[rows, k2], depth[rows, k2] = off2, d2
    return torch.as_tensor(plan.astype(np.int32), device=children.device)


def tree_plan(children: torch.Tensor) -> torch.Tensor:
    """(B, n_anc, 4) int32 plan of (B, n_anc >= 1, 2) int32 children: the
    kernel on a CUDA tensor, ``tree_plan_plain`` on a CPU tensor. Children
    index their tree in the port's order (each child below its parent,
    the root last)."""
    if children.dtype != torch.int32:
        raise TypeError(f"children must be int32, got {children.dtype}")
    if children.dim() != 3 or children.shape[-1] != 2 or children.shape[1] < 1:
        raise ValueError(f"children must be (B, n_anc >= 1, 2), got {tuple(children.shape)}")
    device = children.device
    if device.type == "cpu":
        return tree_plan_plain(children)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    if device.index is not None and device.index != torch.cuda.current_device():
        with torch.cuda.device(device):
            return tree_plan(children)
    batch, n_anc, _ = children.shape
    plan = torch.empty((batch, n_anc, 4), dtype=torch.int32, device=device)
    if batch == 0:
        return plan
    children = children.contiguous()
    if children.data_ptr() % 8:
        children = children.clone()
    launch = plan_launch(n_anc, device_limits(device).smem_optin)
    words = None
    if not launch.staged:
        words = torch.empty((batch, n_anc), dtype=torch.int32, device=device)
    rc = _library().trex_tree_plan(
        children.data_ptr(), plan.data_ptr(), None if words is None else words.data_ptr(),
        batch, n_anc + 1, launch.trees_per_block, int(launch.staged), launch.smem_bytes,
        torch.cuda.current_stream().cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"tree_plan kernel launch failed: CUDA error {rc}")
    tree_plan.launches += 1
    return plan


tree_plan.launches = 0


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _nvcc.load("tree_plan")
    fn = lib.trex_tree_plan
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib
