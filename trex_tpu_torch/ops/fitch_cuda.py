"""K1: batched unit-cost Fitch scores — the CUDA kernel's wrapper, its launch
plan and its plain PyTorch version (counterpart of
``batched_fitch_score_pallas`` in ``trex_tpu/ops/sankoff_pallas.py``).

``batched_fitch_score_cuda`` launches ``csrc/fitch_batched.cu`` for CUDA
tensors and runs ``batched_fitch_score_plain`` for CPU tensors; there is no
other fall back. Its ``launches`` attribute counts the kernel grids it
launches (two a call in the bit-sliced mode: the packing pre-pass and the
walk).
``launch_plan`` picks the kernel's mode and blocks from the shape: rows
staged in shared memory, or, where one tree's rows do not fit there, read
and written in global memory;
``pack_planes`` and ``unpack_planes`` state the bit-sliced layout the kernel
stages its leaves in.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from trex_tpu_torch._device import device_limits
from trex_tpu_torch.ops import _nvcc

THREADS = 256  # threads per block (``kThreads`` in the kernel)
_SM_SHARED = 233472  # shared memory of one SM (bytes); 1 KB of it is reserved per block
_BLOCK_RESERVED = 1024
_MAX_THREADS_PER_SM = 2048
GLOBAL_SCRATCH_BYTES = 1 << 28  # ancestor rows of the global mode's trees in flight


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """How K1 cuts a call: ``planes`` bit planes per 32-site word (0: one
    site per 32-bit word), ``width`` words (or sites) per block, ``slots``
    trees walked at once by each block for ``rounds`` rounds, a grid of
    ``chunks`` x ``tree_groups`` blocks with ``shared_bytes`` of dynamic
    shared memory each. ``staged`` False is the global mode: one thread per
    (tree, site), ``width`` sites a block, each of the ``tree_groups``
    walking ``rounds`` trees in turn over its own ancestor rows in a global
    scratch."""

    planes: int
    width: int
    slots: int
    rounds: int
    chunks: int
    tree_groups: int
    shared_bytes: int
    staged: bool = True

    @property
    def blocks(self) -> int:
        return self.chunks * self.tree_groups


def n_words(length: int) -> int:
    """32-site words of an alignment, padded to whole 128-site groups."""
    return 4 * -(-length // 128)


def planes_for(n_states: int) -> int:
    """Bit planes the kernel uses for an alphabet of ``n_states``: 4 or 8,
    or 0 (one site per word) from 9 states up, where that mode measured
    faster (PERF.md)."""
    if n_states > 32:
        raise ValueError(f"Fitch state sets hold at most 32 states, got {n_states}")
    return 4 if n_states <= 4 else 8 if n_states <= 8 else 0


def shared_bytes(n_taxa: int, planes: int, width: int, slots: int, rounds: int) -> int:
    """The kernel's dynamic shared memory: the staged children (and a raw
    buffer for the next round's when ``rounds > 1``), the leaf rows and
    each slot's ancestor rows, and the chunk's weights."""
    n_anc = n_taxa - 1
    kids = 8 * (slots * n_anc + 2)
    raw = 8 * slots * n_anc if rounds > 1 else 0
    row = planes * width if planes else width
    weight_words = 32 * width if planes else width
    align = lambda b: -(-b // 16) * 16  # noqa: E731
    return align(kids) + align(raw) + 4 * ((n_taxa + slots * n_anc) * row + weight_words)


def _widths(planes: int, units: int) -> list[int]:
    top = 32 if planes else THREADS
    widths = [w for w in (256, 128, 64, 32, 16, 8, 4, 2, 1) if w <= top]
    if not planes:
        widths = [w for w in widths if w >= 4]
    fitting = [w for w in widths if w <= units]
    return fitting or [min(widths)]


def _plan_mode(batch, n_taxa, length, planes, n_sms, smem_optin) -> LaunchPlan | None:
    units = n_words(length) if planes else length
    widths = _widths(planes, units)
    if all(shared_bytes(n_taxa, planes, w, 1, 1) > smem_optin for w in widths):
        return None

    def max_slots(width: int, rounds: int) -> int:
        slots = min(batch, THREADS // width)
        while slots > 0 and shared_bytes(n_taxa, planes, width, slots, rounds) > smem_optin:
            slots -= 1
        return slots

    if batch * units <= 32 * n_sms:
        # Little work: one chain per lane is the time, so take the
        # narrowest chunk (the most blocks) and every tree at once.
        width = min(w for w in widths if shared_bytes(n_taxa, planes, w, 1, 1) <= smem_optin)
        slots = max_slots(width, 1)
        rounds = 1
    else:
        # Enough work to fill the card: the width whose blocks keep the most
        # lanes resident per SM, then the rounds that take the fewest waves
        # x rounds, each a block's walk of its slots' trees.
        best = None
        for width in widths:
            slots = max_slots(width, 2)
            if slots == 0:
                continue
            need = shared_bytes(n_taxa, planes, width, slots, 2)
            per_sm = min(_SM_SHARED // (need + _BLOCK_RESERVED), _MAX_THREADS_PER_SM // THREADS)
            resident = slots * width * per_sm
            if best is None or resident > best[0]:
                best = (resident, width, slots, per_sm)
        if best is None:
            return None
        _, width, slots, per_sm = best
        chunks = -(-units // width)
        resident_blocks = n_sms * per_sm

        def cost(rounds: int) -> tuple[int, int]:
            blocks = chunks * -(-batch // (slots * rounds))
            return -(-blocks // resident_blocks) * rounds, blocks

        rounds = min(range(1, -(-batch // slots) + 1), key=cost)
    groups = -(-batch // (slots * rounds))
    return LaunchPlan(planes, width, slots, rounds, -(-units // width), groups,
                      shared_bytes(n_taxa, planes, width, slots, rounds))


def _plan_global(batch: int, n_taxa: int, length: int, n_sms: int) -> LaunchPlan:
    """The global mode: as many trees in flight as ``GLOBAL_SCRATCH_BYTES``
    of ancestor rows hold (at least one), and the widest block of 32-256
    sites that still gives every SM a block."""
    per_tree = 4 * (n_taxa - 1) * length
    groups = max(1, min(batch, GLOBAL_SCRATCH_BYTES // per_tree, 65535))
    width = next((w for w in (256, 128, 64) if -(-length // w) * groups >= n_sms), 32)
    return LaunchPlan(0, width, 1, -(-batch // groups), -(-length // width), groups, 0,
                      staged=False)


def global_scratch_words(plan: LaunchPlan, n_taxa: int, length: int) -> int:
    """int32 words of the global mode's ancestor rows: one (n_anc, L) table
    per tree group."""
    return plan.tree_groups * (n_taxa - 1) * length


@functools.lru_cache(maxsize=256)
def launch_plan(
    batch: int, n_taxa: int, length: int, n_states: int, n_sms: int, smem_optin: int,
) -> LaunchPlan:
    """K1's mode and blocks for B trees of ``n_taxa`` on ``length`` sites of
    an ``n_states`` alphabet, on a card with ``n_sms`` SMs and
    ``smem_optin`` bytes of opt-in shared memory per block.

    Bit-sliced rows up to 8 states (``planes_for``); one site per word
    above 8 and where bit-sliced rows do not fit. With little work (B x words within one warp per SM) the
    narrowest chunk and every tree in one round; else the chunk width
    that keeps the most lanes resident per SM, the most trees a block
    holds, and the rounds that take the fewest waves x rounds (then the
    fewest blocks). Where not even one tree's rows of the narrowest chunk
    fit in shared memory (above 5811 taxa on an H100), the global mode
    (``_plan_global``), whose limit is the card's memory.
    """
    planes = planes_for(n_states)
    for mode in (planes, 0) if planes else (0,):
        plan = _plan_mode(batch, n_taxa, length, mode, n_sms, smem_optin)
        if plan is not None:
            return plan
    return _plan_global(batch, n_taxa, length, n_sms)


def pack_planes(masks: torch.Tensor, planes: int) -> torch.Tensor:
    """(n_leaves, n_words, planes) int64 bit planes of (n_leaves, L) int32
    state-set masks, as the kernel stages them: bit i of plane q of word w
    is bit q of the mask at site 128 * (w // 4) + 4 * i + w % 4 (0 past L)."""
    n_leaves, length = masks.shape
    words = n_words(length)
    padded = torch.zeros((n_leaves, 32 * words), dtype=torch.int64, device=masks.device)
    padded[:, :length] = masks.to(torch.int64) & 0xFFFFFFFF
    # (leaf, group, i, k) -> (leaf, group, k, i): word 4 * group + k, bit i.
    sites = padded.view(n_leaves, words // 4, 32, 4).transpose(2, 3).reshape(n_leaves, words, 32)
    q = torch.arange(planes, device=masks.device)
    bits = (sites[:, :, None, :] >> q[None, None, :, None]) & 1
    return (bits << torch.arange(32, device=masks.device)).sum(-1)


def unpack_planes(planes: torch.Tensor, length: int) -> torch.Tensor:
    """(n_leaves, L) int32 masks of ``pack_planes``'s output."""
    n_leaves, words, n_planes = planes.shape
    i = torch.arange(32, device=planes.device)
    bits = (planes[..., None] >> i) & 1  # (leaf, word, q, i)
    q = torch.arange(n_planes, device=planes.device)
    sites = (bits << q[None, None, :, None]).sum(2)  # (leaf, word, i)
    flat = sites.view(n_leaves, words // 4, 4, 32).transpose(2, 3).reshape(n_leaves, -1)
    flat = flat[:, :length]
    return (flat - ((flat >> 31) << 32)).to(torch.int32)


def batched_fitch_score_plain(
    children: torch.Tensor, masks: torch.Tensor, weights: torch.Tensor
) -> torch.Tensor:
    """(B,) f32 unit-cost parsimony scores of B trees, in plain PyTorch.

    Args:
        children: (B, n_anc, 2) int32 children of each ancestor.
        masks: (n_leaves, L) int32 leaf state-set bitmasks.
        weights: (L,) f32 site weights.

    Events are counted per site as int32 and multiplied by the weights once
    at the end.
    """
    batch, n_anc, _ = children.shape
    n_leaves = n_anc + 1
    sets = torch.zeros(
        (batch, n_leaves + n_anc, masks.shape[-1]), dtype=torch.int32,
        device=masks.device,
    )
    sets[:, :n_leaves] = masks
    events = torch.zeros((batch, masks.shape[-1]), dtype=torch.int32, device=masks.device)
    rows = torch.arange(batch, device=masks.device)
    for a in range(n_anc):
        s1 = sets[rows, children[:, a, 0]]
        s2 = sets[rows, children[:, a, 1]]
        inter = s1 & s2
        empty = inter == 0
        sets[:, n_leaves + a] = torch.where(empty, s1 | s2, inter)
        events += empty
    return (events.to(torch.float32) * weights).sum(-1)


def _check(children, masks, weights, n_states) -> None:
    if children.dtype != torch.int32 or masks.dtype != torch.int32:
        raise TypeError("children and masks must be int32")
    if weights.dtype != torch.float32:
        raise TypeError("weights must be float32")
    if children.dim() != 3 or children.shape[-1] != 2:
        raise ValueError(f"children must be (B, n_anc, 2), got {tuple(children.shape)}")
    n_leaves = children.shape[1] + 1
    if masks.dim() != 2 or masks.shape[0] != n_leaves:
        raise ValueError(
            f"masks must be ({n_leaves}, L) for {n_leaves} taxa, got {tuple(masks.shape)}"
        )
    if weights.shape != (masks.shape[1],):
        raise ValueError(f"weights must be ({masks.shape[1]},), got {tuple(weights.shape)}")
    if not (children.device == masks.device == weights.device):
        raise ValueError("children, masks and weights must be on one device")
    if n_states is not None and not 1 <= n_states <= 32:
        raise ValueError(f"n_states must be in 1..32, got {n_states}")


def mask_states(masks: torch.Tensor) -> int:
    """The alphabet the masks use: one past their highest set bit (a
    device-to-host copy)."""
    lo, hi = torch.aminmax(masks)
    if int(lo) < 0:
        return 32
    return max(1, int(hi).bit_length())


def batched_fitch_score_cuda(
    children: torch.Tensor, masks: torch.Tensor, weights: torch.Tensor,
    *, n_states: int | None = None,
) -> torch.Tensor:
    """(B,) f32 unit-cost parsimony scores: K1 on a CUDA tensor, the plain
    version on a CPU tensor. Arguments as ``batched_fitch_score_plain``;
    ``n_states`` is the alphabet size (every mask bit lies below it), read
    from the masks with a device-to-host copy when ``None``."""
    _check(children, masks, weights, n_states)
    device = children.device
    if device.type == "cpu":
        return batched_fitch_score_plain(children, masks, weights)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    batch, n_anc, _ = children.shape
    length = masks.shape[1]
    if batch == 0 or length == 0 or n_anc == 0:
        return torch.zeros((batch,), dtype=torch.float32, device=device)
    children = children.contiguous()
    if children.data_ptr() % 8:
        children = children.clone()
    masks = masks.contiguous()
    weights = weights.contiguous()
    if n_states is None:
        n_states = mask_states(masks)
    plan = launch_plan(batch, n_anc + 1, length, n_states, *device_limits(device))
    return run_plan(children, masks, weights, plan)


def run_plan(
    children: torch.Tensor, masks: torch.Tensor, weights: torch.Tensor, plan: LaunchPlan,
    phase_cycles: torch.Tensor | None = None, scratch: torch.Tensor | None = None,
) -> torch.Tensor:
    """Launches K1 with ``plan`` on contiguous CUDA inputs (children 8-byte
    aligned) and returns the (B,) scores; ``phase_cycles``, when given, is
    a (plan.blocks, 4) int64 tensor that receives each block's clock64
    cycles of staging, walks, expansion and children restaging (left as
    it is by the global mode).

    The call's scratch (the packed planes, or the global mode's ancestor
    rows; ``scratch_words``) is a buffer of its own, allocated here, so no
    call and no CUDA graph that captured one reads a buffer another call
    writes or frees. ``scratch``, when given, is an int32 buffer of at
    least that many words that the caller owns instead."""
    device = children.device
    if device.index is not None and device.index != torch.cuda.current_device():
        with torch.cuda.device(device):
            return run_plan(children, masks, weights, plan, phase_cycles, scratch)
    batch, n_anc, _ = children.shape
    length = masks.shape[1]
    scores = torch.empty((batch,), dtype=torch.float32, device=device)
    words = scratch_words(plan, n_anc + 1, length)
    if scratch is None and words:
        scratch = torch.empty((words,), dtype=torch.int32, device=device)
    elif words and (scratch.dtype != torch.int32 or scratch.numel() < words
                    or scratch.device != scores.device):
        raise ValueError(f"scratch must hold {words} int32 words on {scores.device}")
    rc = _library().trex_fitch_batched(
        children.data_ptr(), masks.data_ptr(), weights.data_ptr(),
        scratch.data_ptr() if words else None, scores.data_ptr(),
        None if phase_cycles is None else phase_cycles.data_ptr(),
        batch, n_anc + 1, length, plan.planes, plan.width, plan.slots, plan.rounds,
        plan.chunks, plan.tree_groups, plan.shared_bytes, int(plan.staged),
        torch.cuda.current_stream().cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"fitch_batched kernel launch failed: CUDA error {rc}")
    # Grids: the bit-sliced mode's pre-pass and walk, or the per-site walk.
    batched_fitch_score_cuda.launches += 2 if plan.planes else 1
    return scores


def scratch_words(plan: LaunchPlan, n_taxa: int, length: int) -> int:
    """int32 words of a call's scratch: the leaves' packed planes in the
    bit-sliced mode, the ancestor rows in the global mode, else none."""
    if plan.planes:
        return n_taxa * plan.planes * n_words(length)
    return 0 if plan.staged else global_scratch_words(plan, n_taxa, length)


batched_fitch_score_cuda.launches = 0


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _nvcc.load("fitch_batched")
    fn = lib.trex_fitch_batched
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib
