"""K5: batched min-plus Sankoff scores under a general (Q, Q) cost — the CUDA
kernel's wrapper, its launch plan and its plain PyTorch version
(counterpart of ``batched_sankoff_score_pallas`` in
``trex_tpu/ops/sankoff_pallas.py``).

``batched_sankoff_score_cuda`` launches ``csrc/sankoff_batched.cu`` for
CUDA tensors and runs ``batched_sankoff_score_plain`` for CPU tensors;
there is no other fall back. Its ``launches`` attribute counts the grids a
call launches on the card (its ``calls`` attribute the calls that launch):
the tree-plan pass (``ops.tree_plan``), one DP
grid per chunk of trees (one unless B > 65535, or in the global-slot mode
one per chunk of trees whose slots fit ``GLOBAL_SLOT_BYTES``), then one
site-sum grid. ``launch_plan`` picks where the kernel keeps its slot rows
(``tree_plan.slot_plan``).

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
import functools
import weakref

import torch

from trex_tpu_torch._device import device_limits
from trex_tpu_torch.ops import _nvcc
from trex_tpu_torch.ops.sankoff import batched_root_rows, leaf_dp
from trex_tpu_torch.ops.tree_plan import SlotPlan, slot_plan, slots_for, tree_plan
from trex_tpu_torch.utils.chunking import scan_budget_bytes

_THREADS = 128  # sites per pairwise block of the site sum; per block of the fixed-Q kernels
_MAX_CHUNK = 65535  # grid.y limit: trees per kernel launch
_FIXED_STATES = (4, 20)  # template instantiations; other Q: runtime-Q kernel
_TILE = 16  # parent states per thread of the runtime-Q kernel (its C pitch)
_MAX_ANY_THREADS = 512  # threads per block of the runtime-Q kernel
_MASK_STATES = 32  # int32 state-set bitmasks hold at most 32 states
GLOBAL_SLOT_BYTES = 32 << 20  # global-slot mode: slots of the trees in flight, L2-sized


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


def leaf_codes(q: int, masks: bool) -> int:
    """Rows of the fixed-Q kernels' leaf-message table: a row per state and
    one for any other value, or a row per mask of Q bits up to 8 states (no
    table above)."""
    if masks:
        return 1 << q if q <= 8 else 0
    return q + 1


def launch_plan(n_leaves: int, q: int, hamming: bool, masks: bool, smem_optin: int) -> SlotPlan:
    """K5's slot mode and blocks for ``n_leaves``-taxon trees at Q = ``q``.
    The fixed-Q kernels (Q = 4, 20) hold C, the leaf-message table and
    ``slots`` rows of Q floats a site, a thread a site, 128 sites a block. The runtime-Q
    kernel runs ceil(Q / 16) threads a site (at most 512 a block) and holds
    C transposed at a pitch of Q rounded up to 16 (none in the Hamming
    mode), the leaf-message table in state mode for general costs where C
    and the table take at most half a block's shared memory, a float a
    thread for the root's minima, and either ``slots`` rows of Q floats a
    site or, where those do not fit, nothing more (the global-slot mode)."""
    slots = slots_for(n_leaves)
    if q in _FIXED_STATES:
        codes = leaf_codes(q, masks)
        return slot_plan(slots, 4 * slots * q, 4 * (q * q + codes * q), smem_optin,
                         widths=(_THREADS,), leaf_table=codes > 0)
    pitch = -(-q // _TILE) * _TILE
    tiles = pitch // _TILE
    cost_bytes = 0 if hamming else 4 * q * pitch
    table_bytes = 4 * (q + 1) * pitch
    table = not hamming and not masks and cost_bytes + table_bytes <= smem_optin // 2
    fixed = cost_bytes + (table_bytes if table else 0)
    return slot_plan(slots, 4 * (tiles + slots * q), fixed, smem_optin,
                     threads_per_site=tiles, max_threads=_MAX_ANY_THREADS,
                     global_column_bytes=4 * tiles, leaf_table=table)


def max_states(device: torch.device) -> int:
    """The largest Q of a general cost that the runtime-Q kernel holds on
    ``device``: C transposed at its pitch in one block's shared memory."""
    limit = device_limits(device).smem_optin
    q = 1
    while 4 * (q + 1) * (-(-(q + 1) // _TILE) * _TILE) <= limit:
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
    tests on the host whether ``cost`` is ones - eye. Any Q in the
    Hamming mode; a general cost up to ``max_states`` (240 on an H100),
    above it ``ValueError``."""
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
    if device.index is not None and device.index != torch.cuda.current_device():
        with torch.cuda.device(device):
            return batched_sankoff_score_cuda(
                children, leaves, cost, weights, hamming=hamming,
                sequences_are_masks=sequences_are_masks)
    batch, n_anc, _ = children.shape
    length = leaves.shape[1]
    q = cost.shape[0]
    if q not in _FIXED_STATES and not hamming and q > max_states(device):
        raise ValueError(
            f"sankoff kernel: Q = {q} needs a {q} x {-(-q // _TILE) * _TILE} cost matrix in "
            f"shared memory, above this card's limit (at most {max_states(device)} states)"
        )
    plan = launch_plan(n_anc + 1, q, hamming, sequences_are_masks,
                       device_limits(device).smem_optin)
    if batch == 0 or length == 0:
        return torch.zeros((batch,), dtype=torch.float32, device=device)
    if (n_anc + 1) * length >= 2**31:
        raise ValueError(f"sankoff kernel: {n_anc + 1} x {length} leaf states exceed 2^31")
    steps = tree_plan(children)
    leaves, cost, weights = (x.contiguous() for x in (leaves, cost, weights))
    chunk = min(batch, _MAX_CHUNK)
    slots_g = None
    if plan.mode == "global":
        per_tree = 4 * plan.slots * q * length
        chunk = max(1, min(chunk, GLOBAL_SLOT_BYTES // per_tree))
        slots_g = torch.empty((chunk * per_tree // 4,), dtype=torch.float32, device=device)
    per_site = torch.empty((batch, length), dtype=torch.float32, device=device)
    out = torch.empty((batch,), dtype=torch.float32, device=device)
    rc = _library().trex_sankoff_batched(
        steps.data_ptr(), leaves.data_ptr(), cost.data_ptr(), weights.data_ptr(),
        None if slots_g is None else slots_g.data_ptr(), per_site.data_ptr(), out.data_ptr(),
        batch, n_anc + 1, length, q, int(sequences_are_masks), int(hamming), plan.slots,
        plan.sites_per_block, int(plan.mode == "global"),
        int(plan.leaf_table and q not in _FIXED_STATES), chunk, plan.smem_bytes,
        torch.cuda.current_stream().cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"sankoff_batched kernel launch failed: CUDA error {rc}")
    # Grids: the plan pass, the DP chunks, the site sum.
    batched_sankoff_score_cuda.launches += 1 + -(-batch // chunk) + 1
    batched_sankoff_score_cuda.calls += 1
    return out


batched_sankoff_score_cuda.launches = 0
batched_sankoff_score_cuda.calls = 0


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _nvcc.load("sankoff_batched")
    fn = lib.trex_sankoff_batched
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 12 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib
