"""K1: batched unit-cost Fitch scores — the CUDA kernel's wrapper and its
plain PyTorch version (counterpart of ``batched_fitch_score_pallas`` in
``trex_tpu/ops/sankoff_pallas.py``).

``batched_fitch_score_cuda`` launches ``csrc/fitch_batched.cu`` for CUDA
tensors and runs ``batched_fitch_score_plain`` for CPU tensors; there is no
other fall back. Its ``launches`` attribute counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from trex_tpu_torch.ops import _nvcc

# A block holds one (n_all, sites_per_block) int32 state-set table in shared
# memory; H100 lets a block opt into 227 KB of it.
_SITES_PER_BLOCK = (128, 64, 32, 16, 8)
_H100_SMEM_OPTIN = 232448


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


def sites_per_block(n_leaves: int, device: torch.device) -> int:
    """Widest site chunk whose (n_all, chunk) int32 table fits a block's
    shared memory; raises when even 8 sites do not fit."""
    props = torch.cuda.get_device_properties(device)
    smem = getattr(props, "shared_memory_per_block_optin", _H100_SMEM_OPTIN)
    n_all = 2 * n_leaves - 1
    for spb in _SITES_PER_BLOCK:
        if n_all * spb * 4 <= smem:
            return spb
    raise ValueError(
        f"fitch kernel: {n_leaves} taxa need {n_all * 8 * 4} bytes of shared "
        f"memory for an 8-site block, above this card's {smem}-byte limit "
        f"(at most {smem // 32 // 2} taxa)"
    )


def _check(children, masks, weights) -> None:
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


def batched_fitch_score_cuda(
    children: torch.Tensor, masks: torch.Tensor, weights: torch.Tensor
) -> torch.Tensor:
    """(B,) f32 unit-cost parsimony scores: K1 on a CUDA tensor, the plain
    version on a CPU tensor. Arguments as ``batched_fitch_score_plain``."""
    _check(children, masks, weights)
    device = children.device
    if device.type == "cpu":
        return batched_fitch_score_plain(children, masks, weights)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    batch, n_anc, _ = children.shape
    length = masks.shape[1]
    scores = torch.zeros((batch,), dtype=torch.float32, device=device)
    if batch == 0 or length == 0:
        return scores
    children = children.contiguous()
    masks = masks.contiguous()
    weights = weights.contiguous()
    spb = sites_per_block(n_anc + 1, device)
    lib = _library()
    with torch.cuda.device(device):
        rc = lib.trex_fitch_batched(
            children.data_ptr(), masks.data_ptr(), weights.data_ptr(),
            scores.data_ptr(), batch, n_anc + 1, length, spb,
            torch.cuda.current_stream(device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"fitch_batched kernel launch failed: CUDA error {rc}")
    batched_fitch_score_cuda.launches += 1
    return scores


batched_fitch_score_cuda.launches = 0


def _library() -> ctypes.CDLL:
    lib = _nvcc.load("fitch_batched")
    fn = lib.trex_fitch_batched
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib
