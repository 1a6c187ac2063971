"""K2: the join penalties of one stepwise insertion — the CUDA kernel's
wrapper and its plain PyTorch version (counterpart of
``trex_tpu/ops/insertion_pallas.py``).

``insertion_delta_cuda`` launches ``csrc/insertion_delta.cu`` for CUDA
tensors and runs ``insertion_delta_plain`` for CPU tensors; there is no
other fall back. Its ``launches`` attribute counts kernel launches.
``launch_plan`` sizes the kernel's blocks and shared memory.

Both versions take up tables whose internal rows carry the stepwise event
flag in bit 30 (``search/stepwise.py``): the flag is masked on every read.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from trex_tpu_torch._device import device_limits
from trex_tpu_torch.ops import _nvcc
from trex_tpu_torch.ops.spr_scan import _combine0

THREADS = 256  # threads per block (``kThreads`` in the kernel)
_FLAGLESS = (1 << 30) - 1  # drops the event flag (bits 30 and 31)


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """How K2 cuts the sites: ``sites_per_block`` sites per block, each
    block's (n_all, S) down table (and, when ``staged``, its up rows in
    walk order and the children) in ``shared_bytes`` of shared memory."""

    sites_per_block: int
    blocks: int
    shared_bytes: int
    staged: bool


def _shared_bytes(n_all: int, sites: int, staged: bool) -> int:
    """The kernel's dynamic shared memory: the down table (rows padded to
    an odd pitch), when staged the up rows in walk order and the children,
    then the inserted leaf's row and the weights."""
    n_anc = (n_all - 1) // 2
    pitch = sites | 1
    words = n_all * pitch + 2 * sites
    if staged:
        words += 2 * n_anc * pitch + 2 * n_anc
    return 4 * words


@functools.lru_cache(maxsize=64)
def launch_plan(n_all: int, length: int, smem_optin: int, n_sms: int = 132) -> LaunchPlan:
    """Sites per block for an (n_all, length) up table on a card with
    ``smem_optin`` bytes of opt-in shared memory per block and ``n_sms``
    SMs.

    The walk is one dependent chain per site, so its time does not grow
    with the sites a block holds: S = ceil(length / n_sms) puts about one
    block on each SM. The up rows are staged beside the down table when
    both fit (S shrinks until they do); otherwise the table alone is kept
    and the up rows are read from global memory. An S of 4 or more is
    rounded down to a multiple of 4, so that a block loads its up rows as
    16-byte quads. Raises ``ValueError`` when one site's table does not
    fit.
    """
    target = min(THREADS, max(1, -(-length // n_sms)))
    for staged in (True, False):
        sites = target
        while sites > 1 and _shared_bytes(n_all, sites, staged) > smem_optin:
            sites -= 1
        if sites >= 4:
            sites -= sites % 4
        need = _shared_bytes(n_all, sites, staged)
        if need <= smem_optin:
            return LaunchPlan(sites, -(-length // sites), need, staged)
    raise ValueError(
        f"the insertion kernel needs {need} bytes of shared memory per block for "
        f"{n_all} nodes, above this card's opt-in limit of {smem_optin} bytes"
    )


def insertion_delta_plain(
    var_children: torch.Tensor,
    up_states: torch.Tensor,
    t_node: int,
    weights: torch.Tensor,
) -> torch.Tensor:
    """(n_all,) f32 join penalties delta(t, v) of inserting leaf ``t_node``.

    Args:
        var_children: (n_anc, 2) int32 children of the pruned variant (t's
            parent row already a pass-through pair ``(s, s)``).
        up_states: (n_all, L) int32 Fitch up sets of the variant, flagless
            or with the event flag in bit 30 (masked here); stale rows
            above the stepwise frontier are fine: their contexts only
            reach positions the caller masks.
        t_node: the inserted leaf.
        weights: (L,) f32 site weights.

    ``delta[v]`` is the weighted count of sites where t's set misses the
    combined up/down context of the edge above v; the candidate score is
    L(T minus t) + delta[v] (the SPR identity of ``ops.spr_scan``).
    """
    n_anc = var_children.shape[0]
    n_leaves = n_anc + 1
    up_states = up_states & _FLAGLESS
    down = torch.zeros_like(up_states)
    pairs = var_children.tolist()
    for a in range(n_anc - 1, -1, -1):
        c1, c2 = pairs[a]
        d = down[n_leaves + a]
        if c1 == c2:  # pass-through row: forward the context unchanged
            down[c1] = d
        else:
            ctx1 = _combine0(d, up_states[c2])
            ctx2 = _combine0(d, up_states[c1])
            down[c1] = ctx1
            down[c2] = ctx2
    ctx = _combine0(up_states, down)
    empty_join = (up_states[t_node] & ctx) == 0
    return torch.where(empty_join, weights, 0.0).sum(-1)


def _check(var_children, up_states, t_node, weights) -> None:
    if var_children.dtype != torch.int32 or up_states.dtype != torch.int32:
        raise TypeError("var_children and up_states must be int32")
    if weights.dtype != torch.float32:
        raise TypeError("weights must be float32")
    if var_children.dim() != 2 or var_children.shape[1] != 2:
        raise ValueError(
            f"var_children must be (n_anc, 2), got {tuple(var_children.shape)}"
        )
    n_leaves = var_children.shape[0] + 1
    n_all = 2 * n_leaves - 1
    if up_states.dim() != 2 or up_states.shape[0] != n_all:
        raise ValueError(
            f"up_states must be ({n_all}, L), got {tuple(up_states.shape)}"
        )
    if weights.shape != (up_states.shape[1],):
        raise ValueError(
            f"weights must be ({up_states.shape[1]},), got {tuple(weights.shape)}"
        )
    if not 0 <= t_node < n_leaves:
        raise ValueError(f"t_node {t_node} is not a leaf of {n_leaves}")
    if not (var_children.device == up_states.device == weights.device):
        raise ValueError("var_children, up_states and weights must be on one device")


def insertion_delta_cuda(
    var_children: torch.Tensor,
    up_states: torch.Tensor,
    t_node: int,
    weights: torch.Tensor,
) -> torch.Tensor:
    """(n_all,) f32 insertion penalties: K2 on a CUDA tensor, the plain
    version on a CPU tensor. Arguments as ``insertion_delta_plain``."""
    t_node = int(t_node)
    _check(var_children, up_states, t_node, weights)
    device = up_states.device
    if device.type == "cpu":
        return insertion_delta_plain(var_children, up_states, t_node, weights)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    n_all, length = up_states.shape
    delta = torch.zeros((n_all,), dtype=torch.float32, device=device)
    if length == 0:
        return delta
    var_children = var_children.contiguous()
    up_states = up_states.contiguous()
    weights = weights.contiguous()
    lib = _library()
    limits = device_limits(device)
    plan = launch_plan(n_all, length, limits.smem_optin, limits.n_sms)
    args = (
        var_children.data_ptr(), up_states.data_ptr(), weights.data_ptr(),
        delta.data_ptr(), None, var_children.shape[0] + 1, length, t_node,
        plan.sites_per_block, int(plan.staged), plan.shared_bytes,
        torch.cuda.current_stream(device).cuda_stream,
    )
    if device.index is None or device.index == torch.cuda.current_device():
        rc = lib.trex_insertion_delta(*args)
    else:
        with torch.cuda.device(device):
            rc = lib.trex_insertion_delta(*args)
    if rc != 0:
        raise RuntimeError(f"insertion_delta kernel launch failed: CUDA error {rc}")
    insertion_delta_cuda.launches += 1
    return delta


insertion_delta_cuda.launches = 0


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _nvcc.load("insertion_delta")
    fn = lib.trex_insertion_delta
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib
