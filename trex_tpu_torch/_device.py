"""Device selection: ``cuda`` by default, never a silent fall back to the CPU."""

from __future__ import annotations

from typing import NamedTuple

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The ``torch.device`` for ``device``; raises if it names CUDA and no
    card is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but no CUDA device is available; "
            "pass device='cpu' (CLI: --device cpu) to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r} (cuda or cpu)")
    return dev


class DeviceLimits(NamedTuple):
    """What the kernels' launch plans read of a card: its SM count and the
    opt-in shared memory of one block (bytes)."""

    n_sms: int
    smem_optin: int


_LIMITS: dict[int, DeviceLimits] = {}


def device_limits(device: str | torch.device) -> DeviceLimits:
    """The ``DeviceLimits`` of a CUDA device (the current one when the
    device has no index), read once per device."""
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    limits = _LIMITS.get(index)
    if limits is None:
        props = torch.cuda.get_device_properties(index)
        limits = DeviceLimits(props.multi_processor_count, props.shared_memory_per_block_optin)
        _LIMITS[index] = limits
    return limits
