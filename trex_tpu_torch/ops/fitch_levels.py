"""K6: level-synchronous Fitch scores of the balanced level-order tree — the
CUDA kernel's wrapper, its launch plan and its plain PyTorch version
(counterpart of ``benchmarks/fitch_levels.py``, the TPU's A/B of level
scheduling against the serial ancestor chain of K1).

With leaves ``0..n-1`` and ancestors numbered level by level, ancestor
``a`` has children ``(2a, 2a + 1)``, so each level reads, pair by pair,
the contiguous region the level below wrote. ``fitch_levels_balanced``
launches ``csrc/fitch_levels.cu`` for CUDA tensors and runs
``fitch_levels_plain`` for CPU tensors; there is no other fall back. Its
``launches`` attribute counts the kernel's grids.

Domain (the JAX function's): ``n_leaves`` a power of two (at least 2) and
L a multiple of 128 from 128 to 2048. The JAX function raises ``TypeError``
outside it (a reshape); this one raises ``ValueError``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from trex_tpu_torch._device import device_limits, resolve_device
from trex_tpu_torch.ops import _nvcc
from trex_tpu_torch.topology import Topology, from_numpy

THREADS = 256  # threads per block (``kThreads`` in the kernel)
MAX_DEPTH = 6  # levels a node lane merges in registers (``kMaxDepth``)
WIDTHS = (256, 128, 64, 32)  # sites a block
_SM_SHARED = 233472  # shared memory of one SM (bytes); 1 KB of it is reserved per block
_BLOCK_RESERVED = 1024
_MAX_THREADS_PER_SM = 2048


def _check_leaves(n_leaves: int) -> None:
    if n_leaves < 2 or n_leaves & (n_leaves - 1):
        raise ValueError(f"n_leaves must be a power of two >= 2, got {n_leaves}")


def check_domain(n_leaves: int, length: int) -> None:
    """Raises ``ValueError`` outside the JAX function's domain."""
    _check_leaves(n_leaves)
    if length % 128 or not 128 <= length <= 2048:
        raise ValueError(f"L must be a multiple of 128 from 128 to 2048, got {length}")


def balanced_topology_levels(n_leaves: int, device="cuda") -> Topology:
    """The balanced topology with level-order ancestors: ``children[a] =
    (2a, 2a + 1)``, the root last and its own parent."""
    _check_leaves(n_leaves)
    a = np.arange(n_leaves - 1, dtype=np.int32)
    children = np.stack([2 * a, 2 * a + 1], axis=-1)
    parents = np.empty((2 * n_leaves - 1,), np.int32)
    parents[children.reshape(-1)] = np.repeat(n_leaves + a, 2)
    parents[-1] = 2 * n_leaves - 2
    return from_numpy(children, parents, resolve_device(device))


@dataclasses.dataclass(frozen=True)
class LevelsPlan:
    """How K6 cuts a call: ``width`` sites a block (one per lane) and
    ``THREADS // width`` node lanes, each merging subtrees of
    ``2 ** depth`` leaves in registers; leaf rows ``staged`` in shared
    memory or read from global memory; a grid of ``chunks`` x
    ``tree_groups`` blocks, each scoring ``rounds`` trees in turn, with
    ``shared_bytes`` of dynamic shared memory."""

    width: int
    depth: int
    staged: bool
    chunks: int
    tree_groups: int
    rounds: int
    shared_bytes: int

    @property
    def blocks(self) -> int:
        return self.chunks * self.tree_groups


def _depth(n_leaves: int, lanes: int) -> int:
    """Register levels: enough for the node lanes to share the level
    regions evenly, at most ``MAX_DEPTH``."""
    return min(MAX_DEPTH, max(0, n_leaves.bit_length() - lanes.bit_length()))


def shared_bytes(n_leaves: int, width: int, depth: int, staged: bool) -> int:
    """The staged leaf rows (n x width words, when ``staged``) and the
    level regions (2 * (n >> depth) - 1 rows)."""
    regions = n_leaves >> depth
    return 4 * width * ((n_leaves if staged else 0) + 2 * regions - 1)


def plan_for_width(
    batch: int, n_leaves: int, length: int, width: int, n_sms: int, smem_optin: int,
) -> LevelsPlan | None:
    """K6's plan at ``width`` sites a block (``None`` where not even the
    level regions fit): register levels to share the regions evenly over
    the node lanes, leaf rows staged where they fit, and as many tree
    groups as one wave of resident blocks holds, each block scoring its
    trees in rounds."""
    depth = _depth(n_leaves, THREADS // width)
    staged = shared_bytes(n_leaves, width, depth, True) <= smem_optin
    need = shared_bytes(n_leaves, width, depth, staged)
    if need > smem_optin or length % width:
        return None
    chunks = length // width
    groups = min(batch, 65535, max(1, -(-n_sms * _per_sm(need) // chunks)))
    return LevelsPlan(width, depth, staged, chunks, groups, -(-batch // groups), need)


def _per_sm(need: int) -> int:
    return min(_SM_SHARED // (need + _BLOCK_RESERVED), _MAX_THREADS_PER_SM // THREADS)


@functools.lru_cache(maxsize=256)
def launch_plan(batch: int, n_leaves: int, length: int, n_sms: int, smem_optin: int) -> LevelsPlan:
    """K6's blocks for ``batch`` instances of the ``n_leaves`` tree on
    ``length`` sites, on a card with ``n_sms`` SMs and ``smem_optin`` bytes
    of opt-in shared memory per block.

    The widest of 256, 128, 64 or 32 sites a block whose blocks give each
    SM two (batch x L / width >= 2 x n_sms), else 32 sites, the most
    blocks (``plan_for_width``): a wider block has fewer node lanes, so
    more of the tree is merged in registers and fewer levels in shared
    memory, with a barrier each (measured faster at shapes (a), (a1024)
    and (d) of ``tools/fitch_levels_ab.py``; at (c) 64 sites were, whose
    blocks fit six to an SM: PERF.md). Raises ``ValueError`` outside the
    domain, or where not even the level regions fit in shared memory.
    """
    check_domain(n_leaves, length)
    if batch < 1:
        raise ValueError(f"batch must be >= 1, got {batch}")
    plans = [plan for width in WIDTHS
             if (plan := plan_for_width(batch, n_leaves, length, width, n_sms, smem_optin))]
    if not plans:
        raise ValueError(
            f"fitch levels kernel: the level regions of {n_leaves} leaves do not fit in "
            f"{smem_optin} bytes of shared memory"
        )
    return next((plan for plan in plans if batch * plan.chunks >= 2 * n_sms), plans[-1])


def fitch_levels_plain(leaf_bits: torch.Tensor, n_leaves: int, batch: int) -> torch.Tensor:
    """(batch,) f32 Fitch scores of ``batch`` instances of the balanced
    level-order tree over ``leaf_bits`` ((n_leaves, L) int32 masks), site
    weights 1, in plain PyTorch: level by level, ``inter = d1 & d2``, and
    where that is empty the union and one event."""
    check_domain(n_leaves, leaf_bits.shape[-1])
    sets = leaf_bits.reshape(1, n_leaves, -1).expand(batch, -1, -1)
    events = torch.zeros((batch, sets.shape[-1]), dtype=torch.int32, device=leaf_bits.device)
    while sets.shape[1] > 1:
        pairs = sets.reshape(batch, -1, 2, sets.shape[-1])
        d1, d2 = pairs[:, :, 0], pairs[:, :, 1]
        inter = d1 & d2
        empty = inter == 0
        sets = torch.where(empty, d1 | d2, inter)
        events += empty.sum(1, dtype=torch.int32)
    return events.to(torch.float32).sum(-1)


def _check(leaf_bits: torch.Tensor, n_leaves: int, batch: int) -> None:
    if leaf_bits.dtype != torch.int32:
        raise TypeError("leaf_bits must be int32")
    if leaf_bits.dim() != 2 or leaf_bits.shape[0] != n_leaves:
        raise ValueError(
            f"leaf_bits must be ({n_leaves}, L), got {tuple(leaf_bits.shape)}"
        )
    check_domain(n_leaves, leaf_bits.shape[1])
    if batch < 1:
        raise ValueError(f"batch must be >= 1, got {batch}")


def fitch_levels_balanced(leaf_bits: torch.Tensor, *, n_leaves: int, batch: int) -> torch.Tensor:
    """(batch,) f32 Fitch scores of the balanced level-order tree over
    ``leaf_bits`` ((n_leaves, L) int32 state-set masks), site weights 1, on
    the device of ``leaf_bits``: K6 on a CUDA tensor, the plain version on
    a CPU tensor. Every instance does its own full work."""
    _check(leaf_bits, n_leaves, batch)
    device = leaf_bits.device
    if device.type == "cpu":
        return fitch_levels_plain(leaf_bits, n_leaves, batch)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    plan = launch_plan(batch, n_leaves, leaf_bits.shape[1], *device_limits(device))
    return run_plan(leaf_bits.contiguous(), batch, plan)


def run_plan(
    leaf_bits: torch.Tensor, batch: int, plan: LevelsPlan,
    phase_cycles: torch.Tensor | None = None,
) -> torch.Tensor:
    """Launches K6 with ``plan`` on contiguous CUDA masks and returns the
    (batch,) scores; ``phase_cycles``, when given, is a (plan.blocks, 3)
    int64 tensor that receives each block's clock64 cycles of staging,
    levels and reduction."""
    device = leaf_bits.device
    if device.index is not None and device.index != torch.cuda.current_device():
        with torch.cuda.device(device):
            return run_plan(leaf_bits, batch, plan, phase_cycles)
    n_leaves, length = leaf_bits.shape
    scores = torch.empty((batch,), dtype=torch.float32, device=device)
    rc = _library().trex_fitch_levels(
        leaf_bits.data_ptr(), scores.data_ptr(),
        None if phase_cycles is None else phase_cycles.data_ptr(),
        batch, n_leaves, length, plan.width, plan.depth, int(plan.staged), plan.chunks,
        plan.tree_groups, plan.rounds, plan.shared_bytes,
        torch.cuda.current_stream().cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"fitch_levels kernel launch failed: CUDA error {rc}")
    fitch_levels_balanced.launches += 1
    return scores


fitch_levels_balanced.launches = 0


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _nvcc.load("fitch_levels")
    fn = lib.trex_fitch_levels
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib
