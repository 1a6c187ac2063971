"""Joining a multi-rank world (counterpart of ``trex_tpu/parallel/distributed.py``).

A launcher such as ``torchrun --nproc-per-node N`` starts one process a
rank and sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT``; ``initialize_distributed()`` joins that world. Explicit
arguments (a ``tcp://host:port`` or ``file://path`` address, the world
size and the rank) cover launches without a launcher, as the tests' ranks
do.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from trex_tpu_torch._device import resolve_device

_LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR")


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    initialization_timeout: int = 300,
    *,
    backend: str | None = None,
    device: str | torch.device = "cuda",
) -> bool:
    """Join the ranks' world (idempotent, fail-fast).

    Returns True when a world of more than one rank is up, False in a
    process with no coordinator and no launcher environment (it stays a
    single process, as the JAX function's single-host case does). With a
    coordinator or a launcher's environment a world that cannot form
    raises: nothing quietly runs on one device.

    Args:
        coordinator_address: ``host:port`` (taken as ``tcp://``), or a
            ``tcp://`` or ``file://`` init method; default the launcher's
            ``env://``.
        num_processes, process_id: the world size and this rank (default
            the launcher's ``WORLD_SIZE`` and ``RANK``).
        initialization_timeout: seconds, the process group's timeout (the
            rendezvous and every collective after it), so a rank that dies
            fails the others instead of hanging them.
        backend: default ``nccl`` when ``device`` is CUDA, ``gloo`` on the
            CPU (gloo also runs its collectives on CUDA tensors, which lets
            two ranks share one card).
        device: where this rank's work runs. For CUDA the rank takes card
            ``LOCAL_RANK`` (default its rank) modulo the cards present, as
            the current device.
    """
    if dist.is_initialized():
        return dist.get_world_size() > 1
    launched = all(name in os.environ for name in _LAUNCHER_ENV)
    if coordinator_address is None and not launched:
        return False
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    world_size = int(os.environ["WORLD_SIZE"]) if num_processes is None else num_processes
    rank = int(os.environ["RANK"]) if process_id is None else process_id
    dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method=init_method, world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=initialization_timeout),
    )
    return world_size > 1
