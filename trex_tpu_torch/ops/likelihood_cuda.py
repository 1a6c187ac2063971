"""K3/K4: batched pruning log-likelihoods with power-of-two rescaling — the
CUDA kernel's wrapper and its plain PyTorch version (counterpart of
``batched_log_likelihood_pallas`` in ``trex_tpu/ops/likelihood_pallas.py``,
layouts ``lanes`` and ``slots``).

``batched_log_likelihood_cuda`` launches ``csrc/likelihood_batched.cu`` for
CUDA tensors and runs ``batched_log_likelihood_plain`` for CPU tensors;
there is no other fall back. Its ``launches`` attribute counts the grids a
call launches on the card (its ``calls`` attribute the calls that launch):
the tree-plan pass (``ops.tree_plan``), one
pruning grid (one per 65535 trees), then one site-sum grid (none with
``per_site=True``, whose sums are one torch product); its
``launches_by_mode`` splits that total by the transition's mode,
``"shared"`` (one (Q, Q) P, the K3 regime) and ``"per_branch"`` (a P per
branch and tree, K4's), and ``"per_site"`` counts again the grids of the
calls that returned per-site rows.
``launch_plan`` picks the kernel and its block width: up to 20 states a
fixed kernel (a thread a site, slots in shared memory) at the least width
of ``WIDTHS`` that holds Q, the states zero-padded to it (``pad_states``:
padded states meet zero rows and columns of P and a zero prior, so every
padded term adds +0 and the result is bit for bit Q's); above 20 the
runtime-Q kernel (a site's 16-state tiles in lanes of one warp, each
thread a tile of two sites; its slots in shared memory, or where no width
fits in a global buffer, one pruning grid per chunk of trees whose slots
fit ``GLOBAL_SLOT_BYTES``). Forward only, as the TPU kernel: branch-length
derivatives come from ``ops.likelihood_asr``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from trex_tpu_torch._device import device_limits
from trex_tpu_torch.ops import _nvcc
from trex_tpu_torch.ops.likelihood import highest_matmul_precision, tip_partials
from trex_tpu_torch.ops.tree_plan import (
    SlotPlan,
    resident_threads,
    slot_plan,
    slots_for,
    tree_plan,
)
from trex_tpu_torch.utils.chunking import scan_budget_bytes

WIDTHS = (4, 8, 12, 16, 20)  # the fixed kernels' state counts; above 20: runtime-Q kernel
_MAX_CHUNK = 65535  # grid.y limit: trees per kernel launch
_SITES = 128  # sites (threads) per block of the fixed kernels
_TILE = 16  # parent states per thread of the runtime-Q kernel
_SITES_PER_THREAD = 2  # sites per thread of the runtime-Q kernel
_MAX_ANY_THREADS = 256  # threads per block of the runtime-Q kernel
# A P per branch in the runtime-Q kernel: below this many threads resident
# an SM in the shared-slot mode, the global-slot mode at the same width.
# Set at Q = 61 on 64 taxa (an H100, PERF.md §6: 128 threads shared against
# 384 global, 8.90 against 7.55 ms). It keeps Q = 21 on 64 taxa shared (2.55
# against 2.99 ms global) but takes Q = 61 on 512 taxa global, where shared
# is faster (18.48 against 22.56 ms): the rule is not yet right there.
_BRANCH_GLOBAL_BELOW = 256
_MASK_STATES = 31  # int32 state-set masks (bit 31 is the sign)
GLOBAL_SLOT_BYTES = 32 << 20  # global-slot mode: slots of the trees in flight, L2-sized
_LN2 = 0.6931471805599453


def _chunk_trees(batch: int, per_tree_bytes: int, budget: int) -> int:
    return max(1, min(batch, _MAX_CHUNK, budget // max(per_tree_bytes, 1)))


@highest_matmul_precision
def batched_log_likelihood_plain(
    children: torch.Tensor,
    leaves: torch.Tensor,
    weights: torch.Tensor,
    root_prior: torch.Tensor,
    transition: torch.Tensor,
    *,
    sequences_are_masks: bool = False,
    per_site: bool = False,
):
    """(B,) f32 log-likelihoods of B trees, in plain PyTorch; with
    ``per_site=True`` also their (B, L) unweighted per-site rows, as
    ``(sums, rows)``.

    Args:
        children: (B, n_anc, 2) int32 children of each ancestor.
        leaves: (n_leaves, L) int32 states (negative = missing), or
            state-set bitmasks with ``sequences_are_masks=True``.
        weights: (L,) f32 site weights.
        root_prior: (Q,) f32 root state distribution.
        transition: (Q, Q) f32 shared by every branch, or (B, n_all, Q, Q)
            f32, the matrix of the branch above each node.

    Every ancestor's partial is rescaled by the exact power of two that
    brings its per-site maximum into [1, 2), and the exponent is summed as
    int32 per site — the kernel's arithmetic. Trees are processed in
    chunks whose partial tables fit ``utils.chunking.scan_budget_bytes``.
    """
    batch, n_anc, _ = children.shape
    n_leaves, length = leaves.shape
    q = root_prior.shape[0]
    n_all = n_leaves + n_anc
    device = leaves.device
    shared = transition.dim() == 2
    tips = tip_partials(leaves, q, sequences_are_masks)
    children = children.to(torch.int64)
    out = torch.empty((batch,), dtype=torch.float32, device=device)
    rows_out = (torch.empty((batch, length), dtype=torch.float32, device=device)
                if per_site else None)
    step = _chunk_trees(batch, 4 * n_all * q * length, scan_budget_bytes(device))
    for b0 in range(0, batch, step):
        ch = children[b0 : b0 + step]
        trees = ch.shape[0]
        rows = torch.arange(trees, device=device)
        partials = torch.empty((trees, n_all, q, length), dtype=torch.float32, device=device)
        partials[:, :n_leaves] = tips
        exp_sum = torch.zeros((trees, length), dtype=torch.int32, device=device)
        for a in range(n_anc):
            c1, c2 = ch[:, a, 0], ch[:, a, 1]
            if shared:
                p1 = p2 = transition
            else:
                p1 = transition[b0 + rows, c1]
                p2 = transition[b0 + rows, c2]
            combined = torch.matmul(p1, partials[rows, c1]) * torch.matmul(
                p2, partials[rows, c2]
            )
            e = combined.amax(dim=1).view(torch.int32) >> 23
            inv = ((254 - e) << 23).view(torch.float32)
            partials[:, n_leaves + a] = combined * inv[:, None, :]
            exp_sum += e - 127
        site_lik = (root_prior[None, :, None] * partials[:, -1]).sum(dim=1)
        site_ll = torch.log(torch.clamp(site_lik, min=1e-30)) + exp_sum.to(torch.float32) * _LN2
        out[b0 : b0 + trees] = (site_ll * weights).sum(dim=-1)
        if per_site:
            rows_out[b0 : b0 + trees] = site_ll
    return (out, rows_out) if per_site else out


def kernel_width(q: int) -> int:
    """The states of the fixed kernel that runs Q = ``q``: the least of
    ``WIDTHS`` that holds it, or 0 above 20 (the runtime-Q kernel)."""
    return next((w for w in WIDTHS if w >= q), 0)


def pad_states(x: torch.Tensor, width: int, dims: int) -> torch.Tensor:
    """``x`` (a P or a prior) zero-padded to ``width`` states in its last
    ``dims`` dimensions; ``x`` itself when it has them."""
    pad = width - x.shape[-1]
    return x if pad == 0 else torch.nn.functional.pad(x, (0, pad) * dims)


def slot_states(q: int) -> int:
    """The states a runtime-Q slot row holds: Q rounded up to a tile of 16
    (zero past Q); P's rows likewise."""
    return -(-q // _TILE) * _TILE


def _p_pitch(q: int) -> int:
    """The runtime-Q kernel's P row pitch: its compile-time classes 32 and
    64, else ``slot_states(q)``."""
    return 32 if q <= 32 else 64 if q <= 64 else slot_states(q)


def _lanes(q: int) -> int:
    """Lanes of a site's tiles: ceil(Q / 16) rounded up to a power of two."""
    return 1 << (-(-q // _TILE) - 1).bit_length()


def leaf_codes(q: int, shared_p: bool, masks: bool) -> int:
    """Rows of the fixed kernels' leaf-message table under a shared P: a
    row per state, one for a missing state and one for a state >= Q, or a
    row per mask of Q bits up to 8 states; none above, nor under a
    per-branch P."""
    if not shared_p:
        return 0
    if masks:
        return 1 << q if q <= 8 else 0
    return q + 2


def launch_plan(n_leaves: int, q: int, shared_p: bool, masks: bool, smem_optin: int) -> SlotPlan:
    """K3/K4's blocks for ``n_leaves``-taxon trees at Q = ``q``. The fixed
    kernel of width W = ``kernel_width(q)`` (Q <= 20): 128 sites, a thread
    each, with a shared P (W^2 floats), the leaf-message table and ``slots``
    rows of W floats a site in shared memory. The runtime-Q kernel (Q >
    20): ``_lanes(q) / 2`` threads a site (at most 256 a block); P in
    (``slot_states(q)``, ``_p_pitch(q)``) floats, one matrix under a shared
    P, four under a P per branch (two buffers of a step's two children); the
    leaf-message table (shared P, state mode: Q + 2 rows of
    ``slot_states(q)``) where P and the table take at most half a block's
    shared memory; and either ``slots`` rows of ``slot_states(q)`` floats a
    site or, where those do not fit (or, under a P per branch, leave fewer
    than ``_BRANCH_GLOBAL_BELOW`` threads resident an SM), nothing more (the
    global-slot mode)."""
    slots = slots_for(n_leaves)
    width = kernel_width(q)
    if width:
        codes = leaf_codes(width, shared_p, masks)
        fixed = 4 * (width * width if shared_p else 0) + 4 * codes * width
        return slot_plan(slots, 4 * slots * width, fixed, smem_optin, widths=(_SITES,),
                         leaf_table=codes > 0)
    rows = slot_states(q)
    # P's rows, each tile's 16 shifted 4 floats on (the kernel's p_row).
    p_bytes = 4 * (rows * _p_pitch(q) + rows // _TILE * 4) * (1 if shared_p else 4)
    table_bytes = 4 * (q + 2) * rows
    table = shared_p and not masks and p_bytes + table_bytes <= smem_optin // 2
    fixed = p_bytes + (table_bytes if table else 0)
    plan = slot_plan(slots, 4 * slots * rows, fixed, smem_optin,
                     threads_per_site=_lanes(q) // _SITES_PER_THREAD,
                     max_threads=_MAX_ANY_THREADS, global_column_bytes=0, leaf_table=table)
    if not shared_p and plan.mode == "shared" and plan.resident_threads < _BRANCH_GLOBAL_BELOW:
        threads = plan.sites_per_block * plan.threads_per_site
        plan = dataclasses.replace(plan, mode="global", smem_bytes=fixed,
                                   resident_threads=resident_threads(fixed, threads))
    return plan


def _check(children, leaves, weights, root_prior, transition, sequences_are_masks) -> None:
    if children.dtype != torch.int32 or leaves.dtype != torch.int32:
        raise TypeError("children and leaves must be int32")
    for name, x in (("weights", weights), ("root_prior", root_prior), ("transition", transition)):
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
    if children.dim() != 3 or children.shape[-1] != 2 or children.shape[1] < 1:
        raise ValueError(f"children must be (B, n_anc >= 1, 2), got {tuple(children.shape)}")
    batch, n_anc, _ = children.shape
    n_leaves = n_anc + 1
    if leaves.dim() != 2 or leaves.shape[0] != n_leaves:
        raise ValueError(
            f"leaves must be ({n_leaves}, L) for {n_leaves} taxa, got {tuple(leaves.shape)}"
        )
    if weights.shape != (leaves.shape[1],):
        raise ValueError(f"weights must be ({leaves.shape[1]},), got {tuple(weights.shape)}")
    if root_prior.dim() != 1 or root_prior.shape[0] < 2:
        raise ValueError(
            f"the root prior must be (Q,) with Q >= 2 states, got {tuple(root_prior.shape)}"
        )
    q = root_prior.shape[0]
    if transition.shape not in ((q, q), (batch, 2 * n_leaves - 1, q, q)):
        raise ValueError(
            f"transition must be ({q}, {q}) or ({batch}, {2 * n_leaves - 1}, {q}, {q}), "
            f"got {tuple(transition.shape)}"
        )
    if sequences_are_masks and q > _MASK_STATES:
        raise ValueError(f"int32 state-set masks hold at most {_MASK_STATES} states, got Q = {q}")
    devices = {x.device for x in (children, leaves, weights, root_prior, transition)}
    if len(devices) != 1:
        raise ValueError(f"all inputs must be on one device, got {sorted(map(str, devices))}")


def batched_log_likelihood_cuda(
    children: torch.Tensor,
    leaves: torch.Tensor,
    weights: torch.Tensor,
    root_prior: torch.Tensor,
    transition: torch.Tensor,
    *,
    sequences_are_masks: bool = False,
    per_site: bool = False,
):
    """(B,) f32 log-likelihoods: K3/K4 on CUDA tensors, the plain version on
    CPU tensors. Arguments as ``batched_log_likelihood_plain``; any Q >= 2
    (masks up to 31 states; up to the Q whose P fits a block's shared
    memory, on an H100 240 under a shared P and 112 under a P per branch,
    above it ``ValueError`` from ``launch_plan``). With ``per_site=True``, ``(sums, rows)``: the
    kernel's (B, L) per-site rows under unit weights, without its site-sum
    grid, and their weighted sums as ``batched_log_likelihood_plain`` sums
    them."""
    _check(children, leaves, weights, root_prior, transition, sequences_are_masks)
    device = children.device
    if device.type == "cpu":
        return batched_log_likelihood_plain(
            children, leaves, weights, root_prior, transition,
            sequences_are_masks=sequences_are_masks, per_site=per_site,
        )
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    if device.index is not None and device.index != torch.cuda.current_device():
        with torch.cuda.device(device):
            return batched_log_likelihood_cuda(
                children, leaves, weights, root_prior, transition,
                sequences_are_masks=sequences_are_masks, per_site=per_site)
    batch, n_anc, _ = children.shape
    length = leaves.shape[1]
    q = root_prior.shape[0]
    shared = transition.dim() == 2
    plan = launch_plan(n_anc + 1, q, shared, sequences_are_masks,
                       device_limits(device).smem_optin)
    if batch == 0 or length == 0:
        out = torch.zeros((batch,), dtype=torch.float32, device=device)
        return (out, torch.zeros((batch, length), dtype=torch.float32, device=device)) \
            if per_site else out
    if (n_anc + 1) * length >= 2**31:
        raise ValueError(f"likelihood kernel: {n_anc + 1} x {length} leaf states exceed 2^31")
    children = children.contiguous()
    if children.data_ptr() % 8:
        children = children.clone()
    width = kernel_width(q)
    if width and not shared:
        # A per-branch P zero-padded to the fixed kernel's width (a fill and
        # a copy where Q is not one of WIDTHS); a shared P and the prior are
        # padded by the kernel.
        transition = pad_states(transition, width, 2)
    transition = transition.contiguous()
    if transition.data_ptr() % 16:
        transition = transition.clone()
    leaves, weights, root_prior = (x.contiguous() for x in (leaves, weights, root_prior))
    steps = tree_plan(children)
    chunk = min(batch, _MAX_CHUNK)
    slots_g = None
    if plan.mode == "global":
        per_tree = 4 * plan.slots * slot_states(q) * (-(-length // 4) * 4)
        chunk = max(1, min(chunk, GLOBAL_SLOT_BYTES // per_tree))
        slots_g = torch.empty((chunk * per_tree // 4,), dtype=torch.float32, device=device)
    rows = torch.empty((batch, length), dtype=torch.float32, device=device)
    out = None if per_site else torch.empty((batch,), dtype=torch.float32, device=device)
    # Rows under unit weights; the kernel writes no sum when out is null.
    row_weights = torch.ones_like(weights) if per_site else weights
    rc = _library().trex_likelihood_batched(
        steps.data_ptr(), children.data_ptr(), leaves.data_ptr(), transition.data_ptr(),
        root_prior.data_ptr(), row_weights.data_ptr(),
        None if slots_g is None else slots_g.data_ptr(), rows.data_ptr(),
        None if per_site else out.data_ptr(),
        batch, n_anc + 1, length, q, width, int(shared), int(sequences_are_masks),
        plan.slots, plan.sites_per_block, int(plan.mode == "global"),
        int(plan.leaf_table and not width), chunk, plan.smem_bytes,
        torch.cuda.current_stream().cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"likelihood_batched kernel launch failed: CUDA error {rc}")
    # Grids: the plan pass, the pruning chunks, the site sum (none for rows).
    count_launch(1 + -(-batch // chunk) + (0 if per_site else 1), shared, per_site)
    if per_site:
        return (rows * weights).sum(dim=-1), rows
    return out


def count_launch(grids: int, shared: bool, per_site: bool = False) -> None:
    """Add one launching call of ``grids`` grids to
    ``batched_log_likelihood_cuda``'s counters: its total, its calls, the
    total of its mode and, for a call of per-site rows, ``"per_site"``."""
    fn = batched_log_likelihood_cuda
    fn.launches += grids
    fn.calls += 1
    modes = fn.launches_by_mode
    modes["shared" if shared else "per_branch"] += grids
    if per_site:
        modes["per_site"] = modes.get("per_site", 0) + grids


batched_log_likelihood_cuda.launches = 0
batched_log_likelihood_cuda.calls = 0
batched_log_likelihood_cuda.launches_by_mode = {"shared": 0, "per_branch": 0, "per_site": 0}


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _nvcc.load("likelihood_batched")
    fn = lib.trex_likelihood_batched
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 13 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib
