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
``launch_plan`` picks the kernel and its block width: the fixed kernels at
Q = 4 and 20 (a thread a site, slots in shared memory), the runtime-Q
kernel at any other Q >= 2 (a thread a 16-state tile of a site; its slots
in shared memory, or where no width fits in a global buffer, one pruning
grid per chunk of trees whose slots fit ``GLOBAL_SLOT_BYTES``). Forward
only, as the TPU kernel: branch-length derivatives come from
``ops.likelihood_asr``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from trex_tpu_torch._device import device_limits
from trex_tpu_torch.ops import _nvcc
from trex_tpu_torch.ops.likelihood import highest_matmul_precision, tip_partials
from trex_tpu_torch.ops.tree_plan import SlotPlan, slot_plan, slots_for, tree_plan
from trex_tpu_torch.utils.chunking import scan_budget_bytes

_FIXED_STATES = (4, 20)  # template instantiations; other Q: runtime-Q kernel
_MAX_CHUNK = 65535  # grid.y limit: trees per kernel launch
_SITES = 128  # sites (threads) per block of the fixed kernels
_TILE = 16  # parent states per thread of the runtime-Q kernel (its P pitch)
_MAX_ANY_THREADS = 512  # threads per block of the runtime-Q kernel
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
    kernels (Q = 4, 20): 128 sites, a thread each, with a shared P (Q^2
    floats), the leaf-message table and ``slots`` rows of Q floats a site
    in shared memory. The runtime-Q kernel: ceil(Q / 16) threads a site (at
    most 512 a block), a shared P transposed at a pitch of Q rounded up to
    16, the leaf-message table (shared P, state mode: Q + 2 rows at that
    pitch) where P and the table take at most half a block's shared memory,
    a float a thread for the tiles' maxima, and either ``slots`` rows of Q
    floats a site or, where those do not fit, nothing more (the
    global-slot mode)."""
    slots = slots_for(n_leaves)
    if q in _FIXED_STATES:
        codes = leaf_codes(q, shared_p, masks)
        fixed = 4 * (q * q if shared_p else 0) + 4 * codes * q
        return slot_plan(slots, 4 * slots * q, fixed, smem_optin, widths=(_SITES,),
                         leaf_table=codes > 0)
    pitch = -(-q // _TILE) * _TILE
    tiles = pitch // _TILE
    p_bytes = 4 * q * pitch if shared_p else 0
    table_bytes = 4 * (q + 2) * pitch
    table = shared_p and not masks and p_bytes + table_bytes <= smem_optin // 2
    return slot_plan(slots, 4 * (tiles + slots * q), p_bytes + (table_bytes if table else 0),
                     smem_optin, threads_per_site=tiles, max_threads=_MAX_ANY_THREADS,
                     global_column_bytes=4 * tiles, leaf_table=table)


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
    (masks up to 31 states; under a shared P up to the Q whose transposed P
    fits a block's shared memory, 240 on an H100, above it ``ValueError``
    from ``launch_plan``). With ``per_site=True``, ``(sums, rows)``: the
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
    transition = transition.contiguous()
    if transition.data_ptr() % 16:
        transition = transition.clone()
    leaves, weights, root_prior = (x.contiguous() for x in (leaves, weights, root_prior))
    steps = tree_plan(children)
    chunk = min(batch, _MAX_CHUNK)
    slots_g = None
    if plan.mode == "global":
        per_tree = 4 * plan.slots * q * length
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
        batch, n_anc + 1, length, q, int(shared), int(sequences_are_masks),
        plan.slots, plan.sites_per_block, int(plan.mode == "global"),
        int(plan.leaf_table and q not in _FIXED_STATES), chunk, plan.smem_bytes,
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
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 12 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib
