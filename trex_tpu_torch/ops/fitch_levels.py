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

The kernel has two modes, by the alphabet (K1's ``planes_for``):
bit-sliced state planes up to 8 states (4 or 8 planes, one 32-bit word a
state's bit for 32 sites), one site per 32-bit word above. ``launch_plan``
picks the mode and the blocks; with few trees it splits each tree over
blocks by subtree (``parts``), or takes one site per word at any alphabet
where that grid measured faster.

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
from trex_tpu_torch.ops.fitch_cuda import mask_states, planes_for
from trex_tpu_torch.topology import Topology, from_numpy

THREADS = 256  # threads per block, one site per word (``kThreads`` in the kernel)
MAX_DEPTH = 6  # levels a node lane merges in registers (``kMaxDepth``)
MAX_DEPTH_8 = 5  # the same at 8 planes (``kMaxDepth8``)
WIDTHS = (256, 128, 64, 32)  # sites a block, one site per word
SLICED_THREADS = 512  # threads per block, bit-sliced (``kSlicedThreads``)
WORDS = 4  # 32-site words a block in the bit-sliced mode (``kWords``): 128 sites
TREE_LANES = SLICED_THREADS // WORDS  # slots x node lanes of a bit-sliced block
SPLIT_DEPTH = 3  # register levels of a node lane in the split
SPLIT_THREADS = 256  # threads per block in the split
RAW_LEAVES = 64  # leaves of masks a bit-sliced block copies at a time (``kRawLeaves``)
RAW_BYTES = 4 * 132  # a leaf's 128 raw masks, padded (``kRawStride`` words)
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
    """How K6 cuts a call: ``planes`` bit planes per 32-site word (4 or 8;
    0: one site per 32-bit word); ``width`` words (bit-sliced, always
    ``WORDS``) or sites (one per lane) a block; each tree's ``lanes`` node
    lanes merging subtrees of ``2 ** depth`` leaves in registers; leaf rows
    ``staged`` in shared memory or read from global memory; ``slots``
    trees a block at once; each tree split over ``parts`` blocks by
    subtree (the last one merging the parts' roots); a grid of ``chunks``
    x ``tree_groups`` x ``parts`` blocks, each scoring its trees in
    ``rounds``, with ``shared_bytes`` of dynamic shared memory."""

    planes: int
    width: int
    depth: int
    staged: bool
    chunks: int
    tree_groups: int
    rounds: int
    shared_bytes: int
    slots: int = 1
    lanes: int = 1
    parts: int = 1

    @property
    def threads(self) -> int:
        """Threads a block: one site per word ``THREADS``, bit-sliced
        ``SLICED_THREADS``, in the split ``SPLIT_THREADS``."""
        if not self.planes:
            return THREADS
        return SLICED_THREADS if self.parts == 1 else SPLIT_THREADS

    @property
    def blocks(self) -> int:
        return self.chunks * self.tree_groups * self.parts

    @property
    def mode(self) -> str:
        return f"{self.planes} planes" if self.planes else "one site per word"


def register_depth(n_leaves: int, lanes: int, most: int = MAX_DEPTH) -> int:
    """Register levels: enough for the node lanes to share the level
    regions evenly, at most ``most``."""
    return min(most, max(0, n_leaves.bit_length() - lanes.bit_length()))


def _per_sm(need: int, threads: int = THREADS) -> int:
    return min(_SM_SHARED // (need + _BLOCK_RESERVED), _MAX_THREADS_PER_SM // threads)


def shared_bytes(n_leaves: int, width: int, depth: int, staged: bool) -> int:
    """One site per word: the staged leaf rows (n x width words, when
    ``staged``) and the level regions (2 * (n >> depth) - 1 rows)."""
    regions = n_leaves >> depth
    return 4 * width * ((n_leaves if staged else 0) + 2 * regions - 1)


def sliced_shared_bytes(n_leaves: int, planes: int, depth: int, slots: int, parts: int) -> int:
    """Bit-sliced: rows of 4 x ``planes`` words (``WORDS`` words a plane),
    the part's leaves and each slot's level regions (2 * (n_part >> depth)
    - 1 rows); in the split, at least the parts' roots and the levels
    above them (2 * parts - 1 rows), which the last block merges there;
    then the raw masks of up to ``RAW_LEAVES`` leaves (``RAW_BYTES``
    each)."""
    n_part = n_leaves // parts
    rows = n_part + slots * (2 * (n_part >> depth) - 1)
    if parts > 1:
        rows = max(rows, 2 * parts - 1)
    return 4 * planes * WORDS * rows + RAW_BYTES * min(RAW_LEAVES, n_part)


def plan_for_width(
    batch: int, n_leaves: int, length: int, width: int, n_sms: int, smem_optin: int,
) -> LevelsPlan | None:
    """One site per word at ``width`` sites a block (``None`` where not
    even the level regions fit): register levels to share the regions
    evenly over the node lanes, leaf rows staged where they fit, and as
    many tree groups as one wave of resident blocks holds, each block
    scoring its trees in rounds."""
    lanes = THREADS // width
    depth = register_depth(n_leaves, lanes)
    staged = shared_bytes(n_leaves, width, depth, True) <= smem_optin
    need = shared_bytes(n_leaves, width, depth, staged)
    if need > smem_optin or length % width:
        return None
    chunks = length // width
    groups = min(batch, 65535, max(1, -(-n_sms * _per_sm(need) // chunks)))
    return LevelsPlan(0, width, depth, staged, chunks, groups, -(-batch // groups), need,
                      lanes=lanes)


def sites_plan(
    batch: int, n_leaves: int, length: int, n_sms: int, smem_optin: int,
) -> LevelsPlan | None:
    """One site per word: the widest of 256, 128, 64 or 32 sites a block
    whose blocks give each SM two (batch x L / width >= 2 x n_sms), else
    32 sites, the most blocks (``plan_for_width``; ``None`` where not even
    the level regions fit): a wider block has fewer node lanes, so more of
    the tree is merged in registers and fewer levels in shared memory,
    with a barrier each (measured faster at shapes (a), (a1024) and (d) of
    ``tools/fitch_levels_ab.py``; at (c) 64 sites were, whose blocks fit
    six to an SM: PERF.md)."""
    plans = [plan for width in WIDTHS
             if (plan := plan_for_width(batch, n_leaves, length, width, n_sms, smem_optin))]
    return next((plan for plan in plans if batch * plan.chunks >= 2 * n_sms),
                plans[-1] if plans else None)


def sliced_plan(
    batch: int, n_leaves: int, length: int, planes: int, n_sms: int, smem_optin: int,
) -> LevelsPlan | None:
    """The bit-sliced plan (``None`` where it does not fit in shared
    memory or the grid): blocks of ``SLICED_THREADS`` threads
    (``SPLIT_THREADS`` in the split) on 128 sites (``chunks`` = L / 128),
    register depth as ``register_depth`` (at most ``MAX_DEPTH_8`` at 8
    planes).

    With at least two (tree, chunk) pairs an SM, one block scores
    ``TREE_LANES // lanes`` trees from the leaf rows it staged: the fewest
    node lanes a tree (1, 2, 4, ... up to n / 2) whose blocks reach 7/8
    of the SMs (128 of 132 on an H100), so the fewest blocks stage the
    same leaves, and as many tree groups as one wave of resident blocks
    holds, the rest in rounds. With fewer pairs, the split: each tree over
    the fewest ``parts`` (at most n / 2) that give each SM two blocks, one
    tree a block, node lanes of ``2 ** SPLIT_DEPTH`` leaves (at most
    ``SPLIT_THREADS // WORDS`` lanes, deeper where a part has more).
    Either way ``parts`` doubles while the part's rows do not fit."""
    chunks = length // (32 * WORDS)
    most = MAX_DEPTH_8 if planes == 8 else MAX_DEPTH
    parts = 1
    if batch * chunks < 2 * n_sms:
        while parts < n_leaves // 2 and batch * chunks * parts < 2 * n_sms:
            parts *= 2
    while True:
        n_part = n_leaves // parts
        if parts > 1:
            tree_lanes = min(SPLIT_THREADS // WORDS, max(1, n_part >> SPLIT_DEPTH))
            slots, groups = 1, batch
        else:
            tree_lanes = 1
            while (tree_lanes < min(TREE_LANES, n_leaves // 2)
                   and 8 * chunks * -(-batch // (TREE_LANES // tree_lanes)) < 7 * n_sms):
                tree_lanes *= 2
            slots = min(batch, TREE_LANES // tree_lanes)
            groups = None
        depth = register_depth(n_part, tree_lanes, most)
        need = sliced_shared_bytes(n_leaves, planes, depth, slots, parts)
        if need <= smem_optin or parts >= n_leaves // 2:
            break
        parts *= 2
    if need > smem_optin or parts > 65535:
        return None
    if groups is None:
        wave = n_sms * _per_sm(need, SLICED_THREADS)
        groups = min(-(-batch // slots), 65535, max(1, -(-wave // chunks)))
    elif groups > 65535:
        return None
    return LevelsPlan(planes, WORDS, depth, True, chunks, groups, -(-batch // (slots * groups)),
                      need, slots=slots, lanes=tree_lanes, parts=parts)


@functools.lru_cache(maxsize=256)
def launch_plan(
    batch: int, n_leaves: int, length: int, n_states: int, n_sms: int, smem_optin: int,
) -> LevelsPlan:
    """K6's mode and blocks for ``batch`` instances of the ``n_leaves`` tree
    on ``length`` sites of an ``n_states`` alphabet, on a card with
    ``n_sms`` SMs and ``smem_optin`` bytes of opt-in shared memory per
    block: bit-sliced up to 8 states (``sliced_plan``), else one site per
    word (``sites_plan``). Raises ``ValueError`` outside the domain, or
    where no plan fits.

    Where the bit-sliced plan splits each tree over blocks because there
    are few trees (fewer (tree, chunk) pairs than two an SM), the plan
    takes one site per word instead where that grid has at most two blocks
    an SM with its leaf rows staged, or more than one an SM with them read
    from global memory. On an H100 80GB HBM3 at 700.00 W that was the
    faster of the two, or within 8% of it, at 59 of 60 shapes (B = 1-8,
    128-4096 leaves, 1024 and 2048 sites; ``tools/fitch_levels_ab.py``'s
    crossover, PERF.md): the split's ticket and top merge cost more than
    staging up to 1024 leaves in each of 32-256 blocks; under one wave of
    blocks that read their rows from global memory the split is faster,
    above it not."""
    check_domain(n_leaves, length)
    if batch < 1:
        raise ValueError(f"batch must be >= 1, got {batch}")
    planes = planes_for(n_states)
    sites = sites_plan(batch, n_leaves, length, n_sms, smem_optin)
    if not planes:
        if sites is None:
            raise ValueError(
                f"fitch levels kernel: the level regions of {n_leaves} leaves do not fit in "
                f"{smem_optin} bytes of shared memory"
            )
        return sites
    plan = sliced_plan(batch, n_leaves, length, planes, n_sms, smem_optin)
    if plan is None:
        raise ValueError(
            f"fitch levels kernel: no bit-sliced plan for {batch} trees of {n_leaves} leaves "
            f"in {smem_optin} bytes of shared memory"
        )
    if (plan.parts > 1 and batch * plan.chunks < 2 * n_sms and sites is not None
            and (sites.blocks <= 2 * n_sms if sites.staged else sites.blocks > n_sms)):
        return sites
    return plan


def split_scratch_words(plan: LevelsPlan) -> int:
    """int32 words of the split's scratch, after the scores (padded to 4
    words): one ticket a (tree group, chunk), padded to 4, then the parts'
    root rows."""
    if plan.parts == 1:
        return 0
    tickets = plan.tree_groups * plan.chunks
    return -(-tickets // 4) * 4 + tickets * plan.parts * plan.planes * WORDS


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


def _check(leaf_bits: torch.Tensor, n_leaves: int, batch: int, n_states) -> None:
    if leaf_bits.dtype != torch.int32:
        raise TypeError("leaf_bits must be int32")
    if leaf_bits.dim() != 2 or leaf_bits.shape[0] != n_leaves:
        raise ValueError(
            f"leaf_bits must be ({n_leaves}, L), got {tuple(leaf_bits.shape)}"
        )
    check_domain(n_leaves, leaf_bits.shape[1])
    if batch < 1:
        raise ValueError(f"batch must be >= 1, got {batch}")
    if n_states is not None and not 1 <= n_states <= 32:
        raise ValueError(f"n_states must be in 1..32, got {n_states}")


def fitch_levels_balanced(
    leaf_bits: torch.Tensor, *, n_leaves: int, batch: int, n_states: int | None = None,
) -> torch.Tensor:
    """(batch,) f32 Fitch scores of the balanced level-order tree over
    ``leaf_bits`` ((n_leaves, L) int32 state-set masks), site weights 1, on
    the device of ``leaf_bits``: K6 on a CUDA tensor, the plain version on
    a CPU tensor. Every instance does its own full work. ``n_states`` is
    the alphabet size (every mask bit lies below it; it picks the mode),
    read from the masks with one device-to-host copy when ``None``."""
    _check(leaf_bits, n_leaves, batch, n_states)
    device = leaf_bits.device
    if device.type == "cpu":
        return fitch_levels_plain(leaf_bits, n_leaves, batch)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    leaf_bits = leaf_bits.contiguous()
    if leaf_bits.data_ptr() % 16:
        leaf_bits = leaf_bits.clone()
    if n_states is None:
        n_states = mask_states(leaf_bits)
    plan = launch_plan(batch, n_leaves, leaf_bits.shape[1], n_states, *device_limits(device))
    return run_plan(leaf_bits, batch, plan)


def run_plan(
    leaf_bits: torch.Tensor, batch: int, plan: LevelsPlan,
    phase_cycles: torch.Tensor | None = None,
) -> torch.Tensor:
    """Launches K6 with ``plan`` on contiguous, 16-byte aligned CUDA masks
    and returns the (batch,) scores; ``phase_cycles``, when given, is a
    (plan.blocks, 4) int64 tensor that receives each block's clock
    cycles of staging, levels, the split's top (0 outside it) and
    reduction. The scores lead a buffer of the call's own that also
    holds the split's tickets and part roots (``split_scratch_words``),
    zeroed with the scores on the stream."""
    device = leaf_bits.device
    if device.index is not None and device.index != torch.cuda.current_device():
        with torch.cuda.device(device):
            return run_plan(leaf_bits, batch, plan, phase_cycles)
    n_leaves, length = leaf_bits.shape
    words = split_scratch_words(plan)
    out = torch.empty((-(-batch // 4) * 4 + words if words else batch,),
                      dtype=torch.int32, device=device)
    rc = _library().trex_fitch_levels(
        leaf_bits.data_ptr(), out.data_ptr(),
        None if phase_cycles is None else phase_cycles.data_ptr(),
        batch, n_leaves, length, plan.planes, plan.width, plan.depth, int(plan.staged),
        plan.slots, plan.lanes, plan.parts, plan.chunks, plan.tree_groups, plan.rounds,
        plan.shared_bytes, torch.cuda.current_stream().cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"fitch_levels kernel launch failed: CUDA error {rc}")
    fitch_levels_balanced.launches += 1
    return out[:batch].view(torch.float32)


fitch_levels_balanced.launches = 0


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _nvcc.load("fitch_levels")
    fn = lib.trex_fitch_levels
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 14 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib
