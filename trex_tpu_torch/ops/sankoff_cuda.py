"""K5: batched min-plus Sankoff scores under a general (Q, Q) cost — the CUDA
kernel's wrapper and its plain PyTorch version (counterpart of
``batched_sankoff_score_pallas`` in ``trex_tpu/ops/sankoff_pallas.py``).

``batched_sankoff_score_cuda`` launches ``csrc/sankoff_batched.cu`` for
CUDA tensors and runs ``batched_sankoff_score_plain`` for CPU tensors;
there is no other fall back. Its ``launches`` attribute counts the grids a
call launches on the card: one DP grid per chunk of trees that fits the
scratch buffer, then one site-sum grid.

Both versions add a tree's weighted per-site root minima in the same
order — a pairwise tree over each block of 128 sites, then the blocks in
index order — and every other step is a single rounded add, min or
multiply, so the plain version equals the kernel bit for bit for any cost.
For integer (or dyadic) costs with integer weights every value and every
partial sum is exact in float32 below 2^24, so both also equal the JAX
package's scores, whatever its summation order.
"""

from __future__ import annotations

import ctypes
import weakref

import torch

from trex_tpu_torch._device import device_limits
from trex_tpu_torch.ops import _nvcc
from trex_tpu_torch.ops.sankoff import batched_root_rows, leaf_dp
from trex_tpu_torch.utils.chunking import scan_budget_bytes

_THREADS = 128  # sites per block of the kernel
_MAX_CHUNK = 65535  # grid.y limit: trees per kernel launch
_SCRATCH_BYTES = 2 << 30  # ancestor scratch per call on the card
_FIXED_STATES = (4, 20)  # template instantiations; other Q: runtime-Q kernel
_STATIC_SMEM = 4 * _THREADS  # the block reduction's static shared array
_MASK_STATES = 32  # int32 state-set bitmasks hold at most 32 states


def _chunk_trees(batch: int, per_tree_bytes: int, budget: int) -> int:
    return max(1, min(batch, _MAX_CHUNK, budget // max(per_tree_bytes, 1)))


_HAMMING: dict[int, tuple] = {}


def is_hamming(cost: torch.Tensor) -> bool:
    """Host-side test for the unit cost ``ones - eye``. The answer is kept
    per tensor and version, so a cost matrix reused across calls (a climb's,
    ``bench``'s) is copied to the host once, not on every call."""
    key = id(cost)
    hit = _HAMMING.get(key)
    if hit is not None and hit[0]() is cost and hit[1] == cost._version:
        return hit[2]
    c = cost.detach().cpu().to(torch.float64)
    q = c.shape[-1]
    answer = bool(torch.equal(
        c, torch.ones((q, q), dtype=torch.float64) - torch.eye(q, dtype=torch.float64)))
    _HAMMING[key] = (weakref.ref(cost, lambda _: _HAMMING.pop(key, None)), cost._version, answer)
    return answer


def ordered_site_sum(values: torch.Tensor) -> torch.Tensor:
    """(B,) sums of (B, L) f32 ``values`` in the kernel's order: a pairwise
    tree over each 128-site block (zero-padded), then the blocks in index
    order."""
    batch, length = values.shape
    n_blocks = -(-length // _THREADS)
    x = torch.zeros((batch, n_blocks * _THREADS), dtype=values.dtype, device=values.device)
    x[:, :length] = values
    x = x.view(batch, n_blocks, _THREADS)
    stride = _THREADS // 2
    while stride:
        x = x[..., :stride] + x[..., stride : 2 * stride]
        stride //= 2
    total = torch.zeros((batch,), dtype=values.dtype, device=values.device)
    for k in range(n_blocks):
        total = total + x[:, k, 0]
    return total


def batched_sankoff_score_plain(
    children: torch.Tensor,
    leaves: torch.Tensor,
    cost: torch.Tensor,
    weights: torch.Tensor,
    *,
    hamming: bool = False,
    sequences_are_masks: bool = False,
) -> torch.Tensor:
    """(B,) f32 Sankoff scores of B trees, in plain PyTorch.

    Args:
        children: (B, n_anc, 2) int32 children of each ancestor.
        leaves: (n_leaves, L) int32 states, or state-set bitmasks with
            ``sequences_are_masks=True``.
        cost: (Q, Q) f32, ``cost[parent_state, child_state]``.
        weights: (L,) f32 site weights.
        hamming: take the closed-form messages (``cost`` is ones - eye).

    Each ancestor step is vectorised over trees, children, states and
    sites; trees run in chunks whose tables (and, in the general mode, the
    (2, Q, Q, L) min-plus temporary) fit ``utils.chunking.scan_budget_bytes``.
    """
    batch, n_anc, _ = children.shape
    n_leaves, length = leaves.shape
    q = cost.shape[-1]
    leaf_table = leaf_dp(leaves, q, sequences_are_masks)
    per_tree = 4 * length * ((n_leaves + n_anc) * q + (0 if hamming else 4 * q * q))
    step = _chunk_trees(batch, per_tree, scan_budget_bytes(leaves.device))
    per_site = torch.empty((batch, length), dtype=torch.float32, device=leaves.device)
    for b0 in range(0, batch, step):
        root = batched_root_rows(children[b0 : b0 + step], leaf_table, cost, hamming)
        per_site[b0 : b0 + step] = root.amin(dim=1) * weights
    return ordered_site_sum(per_site)


def max_states(device: torch.device) -> int:
    """The largest Q the runtime-Q kernel holds in one block's shared
    memory on ``device``: (Q^2 + 2 x 128 x Q) floats of cost matrix and
    child rows."""
    limit = device_limits(device).smem_optin - _STATIC_SMEM
    q = 1
    while 4 * ((q + 1) ** 2 + 2 * _THREADS * (q + 1)) <= limit:
        q += 1
    return q


def _check(children, leaves, cost, weights, sequences_are_masks) -> None:
    if children.dtype != torch.int32 or leaves.dtype != torch.int32:
        raise TypeError("children and leaves must be int32")
    for name, x in (("cost", cost), ("weights", weights)):
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
    if children.dim() != 3 or children.shape[-1] != 2 or children.shape[1] < 1:
        raise ValueError(f"children must be (B, n_anc >= 1, 2), got {tuple(children.shape)}")
    n_leaves = children.shape[1] + 1
    if leaves.dim() != 2 or leaves.shape[0] != n_leaves:
        raise ValueError(
            f"leaves must be ({n_leaves}, L) for {n_leaves} taxa, got {tuple(leaves.shape)}"
        )
    if weights.shape != (leaves.shape[1],):
        raise ValueError(f"weights must be ({leaves.shape[1]},), got {tuple(weights.shape)}")
    if cost.dim() != 2 or cost.shape[0] != cost.shape[1] or cost.shape[0] < 1:
        raise ValueError(f"cost must be (Q, Q), got {tuple(cost.shape)}")
    if sequences_are_masks and cost.shape[0] > _MASK_STATES:
        raise ValueError(
            f"int32 state-set masks hold at most {_MASK_STATES} states, got Q = "
            f"{cost.shape[0]}; pass integer states"
        )
    devices = {x.device for x in (children, leaves, cost, weights)}
    if len(devices) != 1:
        raise ValueError(f"all inputs must be on one device, got {sorted(map(str, devices))}")


def batched_sankoff_score_cuda(
    children: torch.Tensor,
    leaves: torch.Tensor,
    cost: torch.Tensor,
    weights: torch.Tensor,
    *,
    hamming: bool | None = None,
    sequences_are_masks: bool = False,
) -> torch.Tensor:
    """(B,) f32 Sankoff scores: K5 on CUDA tensors, the plain version on CPU
    tensors. Arguments as ``batched_sankoff_score_plain``; ``hamming=None``
    tests on the host whether ``cost`` is ones - eye. Any Q whose cost
    matrix and child rows fit a block's shared memory (``max_states``: 144
    on an H100); a larger Q raises ``ValueError``."""
    _check(children, leaves, cost, weights, sequences_are_masks)
    if hamming is None:
        hamming = is_hamming(cost)
    device = children.device
    if device.type == "cpu":
        return batched_sankoff_score_plain(
            children, leaves, cost, weights,
            hamming=hamming, sequences_are_masks=sequences_are_masks,
        )
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    batch, n_anc, _ = children.shape
    length = leaves.shape[1]
    q = cost.shape[0]
    if q not in _FIXED_STATES and q > max_states(device):
        raise ValueError(
            f"sankoff kernel: Q = {q} needs {4 * (q * q + 2 * _THREADS * q)} bytes of "
            f"shared memory per block, above this card's limit (at most "
            f"{max_states(device)} states)"
        )
    if batch == 0 or length == 0:
        return torch.zeros((batch,), dtype=torch.float32, device=device)
    out = torch.empty((batch,), dtype=torch.float32, device=device)
    children, leaves, cost, weights = (x.contiguous() for x in (children, leaves, cost, weights))
    per_tree = 4 * n_anc * q * length
    chunk = _chunk_trees(batch, per_tree, _SCRATCH_BYTES)
    scratch = torch.empty((chunk * per_tree // 4,), dtype=torch.float32, device=device)
    block_sums = torch.empty(
        (batch, (length + _THREADS - 1) // _THREADS), dtype=torch.float32, device=device
    )
    lib = _library()
    with torch.cuda.device(device):
        rc = lib.trex_sankoff_batched(
            children.data_ptr(), leaves.data_ptr(), cost.data_ptr(), weights.data_ptr(),
            scratch.data_ptr(), block_sums.data_ptr(), out.data_ptr(),
            batch, n_anc + 1, length, q, int(sequences_are_masks), int(hamming), chunk,
            torch.cuda.current_stream(device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"sankoff_batched kernel launch failed: CUDA error {rc}")
    batched_sankoff_score_cuda.launches += -(-batch // chunk) + 1
    return out


batched_sankoff_score_cuda.launches = 0


def _library() -> ctypes.CDLL:
    lib = _nvcc.load("sankoff_batched")
    fn = lib.trex_sankoff_batched
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib
