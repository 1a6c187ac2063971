"""Checkpoint and resume for long searches (counterpart of
``trex_tpu/utils/checkpoint.py``): a dictionary of tensors, numbers and
optimizer ``state_dict``s saved with ``torch.save`` into a ``step_N/``
directory, written to a temporary file and renamed into place."""

from __future__ import annotations

import os
from typing import Any

import torch

_FILE = "state.pt"


def save_checkpoint(path: str, state: dict[str, Any]) -> None:
    """Save ``state`` into the directory ``path``, overwriting."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, f"{_FILE}.{os.getpid()}.tmp")
    torch.save(state, tmp)
    os.replace(tmp, os.path.join(path, _FILE))


def restore_checkpoint(path: str, map_location=None) -> dict[str, Any]:
    """The state saved in ``path``, its tensors on ``map_location`` (where
    they were saved when None)."""
    return torch.load(os.path.join(os.path.abspath(path), _FILE),
                      map_location=map_location, weights_only=True)


def latest_step_dir(root: str) -> str | None:
    """The highest-numbered ``step_*`` subdirectory under ``root``."""
    if not os.path.isdir(root):
        return None
    steps = [d for d in os.listdir(root) if d.startswith("step_")]
    if not steps:
        return None
    best = max(steps, key=lambda d: int(d.split("_")[1]))
    return os.path.join(root, best)
