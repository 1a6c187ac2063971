"""K3/K4: batched pruning log-likelihoods with power-of-two rescaling — the
CUDA kernel's wrapper and its plain PyTorch version (counterpart of
``batched_log_likelihood_pallas`` in ``trex_tpu/ops/likelihood_pallas.py``,
layouts ``lanes`` and ``slots``).

``batched_log_likelihood_cuda`` launches ``csrc/likelihood_batched.cu`` for
CUDA tensors and runs ``batched_log_likelihood_plain`` for CPU tensors;
there is no other fall back. Its ``launches`` attribute counts the grids a
call launches on the card (its ``calls`` attribute the calls that launch):
the tree-plan pass (``ops.tree_plan``), one
pruning grid (one per 65535 trees), then one site-sum grid.
``launch_plan`` picks the kernel's block width: its slots always sit in
shared memory. Forward only, as the TPU kernel: branch-length derivatives
come from ``ops.likelihood_asr``.
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

SUPPORTED_STATES = (4, 20)
_MAX_CHUNK = 65535  # grid.y limit: trees per kernel launch
_SITES = 128  # sites (threads) per block of the kernel
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
) -> torch.Tensor:
    """(B,) f32 log-likelihoods of B trees, in plain PyTorch.

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
        per_site = torch.log(torch.clamp(site_lik, min=1e-30)) + exp_sum.to(torch.float32) * _LN2
        out[b0 : b0 + trees] = (per_site * weights).sum(dim=-1)
    return out


def leaf_codes(q: int, shared_p: bool, masks: bool) -> int:
    """Rows of the kernel's leaf-message table under a shared P: a row per
    state, one for a missing state and one for a state >= Q, or a row per
    mask of Q bits up to 8 states; none above, nor under a per-branch P."""
    if not shared_p:
        return 0
    if masks:
        return 1 << q if q <= 8 else 0
    return q + 2


def launch_plan(n_leaves: int, q: int, shared_p: bool, masks: bool, smem_optin: int) -> SlotPlan:
    """K3/K4's blocks for ``n_leaves``-taxon trees at Q = ``q``: 128
    sites, with a shared P (Q^2 floats), the leaf-message table and
    ``slots`` rows of Q floats a site in shared memory."""
    slots = slots_for(n_leaves)
    codes = leaf_codes(q, shared_p, masks)
    fixed = 4 * (q * q if shared_p else 0) + 4 * codes * q
    return slot_plan(slots, 4 * slots * q, fixed, smem_optin, widths=(_SITES,),
                     leaf_table=codes > 0)


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
    if root_prior.dim() != 1 or root_prior.shape[0] not in SUPPORTED_STATES:
        raise ValueError(
            f"the likelihood kernel supports Q in {SUPPORTED_STATES} states, "
            f"got a root prior of shape {tuple(root_prior.shape)}"
        )
    q = root_prior.shape[0]
    if transition.shape not in ((q, q), (batch, 2 * n_leaves - 1, q, q)):
        raise ValueError(
            f"transition must be ({q}, {q}) or ({batch}, {2 * n_leaves - 1}, {q}, {q}), "
            f"got {tuple(transition.shape)}"
        )
    if sequences_are_masks and q > 31:
        raise ValueError("int32 state-set masks hold at most 31 states")
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
) -> torch.Tensor:
    """(B,) f32 log-likelihoods: K3/K4 on CUDA tensors, the plain version on
    CPU tensors. Arguments as ``batched_log_likelihood_plain``; Q must be 4
    or 20."""
    _check(children, leaves, weights, root_prior, transition, sequences_are_masks)
    device = children.device
    if device.type == "cpu":
        return batched_log_likelihood_plain(
            children, leaves, weights, root_prior, transition,
            sequences_are_masks=sequences_are_masks,
        )
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    if device.index is not None and device.index != torch.cuda.current_device():
        with torch.cuda.device(device):
            return batched_log_likelihood_cuda(
                children, leaves, weights, root_prior, transition,
                sequences_are_masks=sequences_are_masks)
    batch, n_anc, _ = children.shape
    length = leaves.shape[1]
    q = root_prior.shape[0]
    shared = transition.dim() == 2
    plan = launch_plan(n_anc + 1, q, shared, sequences_are_masks,
                       device_limits(device).smem_optin)
    if batch == 0 or length == 0:
        return torch.zeros((batch,), dtype=torch.float32, device=device)
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
    per_site = torch.empty((batch, length), dtype=torch.float32, device=device)
    out = torch.empty((batch,), dtype=torch.float32, device=device)
    rc = _library().trex_likelihood_batched(
        steps.data_ptr(), children.data_ptr(), leaves.data_ptr(), transition.data_ptr(),
        root_prior.data_ptr(), weights.data_ptr(), per_site.data_ptr(), out.data_ptr(),
        batch, n_anc + 1, length, q, int(shared), int(sequences_are_masks),
        chunk, plan.smem_bytes, torch.cuda.current_stream().cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"likelihood_batched kernel launch failed: CUDA error {rc}")
    # Grids: the plan pass, the pruning chunks, the site sum.
    batched_log_likelihood_cuda.launches += 1 + -(-batch // chunk) + 1
    batched_log_likelihood_cuda.calls += 1
    return out


batched_log_likelihood_cuda.launches = 0
batched_log_likelihood_cuda.calls = 0


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _nvcc.load("likelihood_batched")
    fn = lib.trex_likelihood_batched
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib
