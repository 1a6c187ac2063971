"""Long-running search driver: segmented, checkpointed, resumable
(counterpart of ``trex_tpu/search/runner.py``).

The annealed joint search runs in segments of ``checkpoint_every`` steps,
with (params, optimizer state, step) checkpointed between segments and a
JSON line of metrics per segment. Resuming from the latest checkpoint
continues the exact schedule: temperatures derive from global step indices
and each step's Gumbel noise from a generator seeded by (seed, global
step) alone (``step_seed``, the counterpart of ``fold_in(base_key,
step)``), so on one device an interrupted run is bit-identical to an
uninterrupted one.
"""

from __future__ import annotations

import dataclasses
import os

import torch

from trex_tpu_torch.ops.relax import gumbel
from trex_tpu_torch.search.joint import (
    JointConfig,
    is_batched,
    anneal,
    init_params,
    joint_loss_fn,
    run_steps,
)
from trex_tpu_torch.search.optimizers import make_optimizer
from trex_tpu_torch.utils.checkpoint import latest_step_dir, restore_checkpoint, save_checkpoint
from trex_tpu_torch.utils.metrics import MetricsLogger

_MASK64 = (1 << 64) - 1


@dataclasses.dataclass(frozen=True)
class RunnerConfig:
    workdir: str
    n_iterations: int = 10000
    checkpoint_every: int = 1000
    seed: int = 0
    joint: JointConfig = JointConfig()


def step_seed(seed: int, step: int) -> int:
    """A 63-bit generator seed that depends only on (``seed``, ``step``):
    two rounds of the splitmix64 finaliser over the pair."""
    x = (seed & _MASK64) ^ 0x9E3779B97F4A7C15
    for word in (step & _MASK64, 0xD1B54A32D192ED03):
        x = (x + word) & _MASK64
        x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
        x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
        x ^= x >> 31
    return x >> 1


def run_search(
    cfg: RunnerConfig,
    leaf_tensor: torch.Tensor,
    resume: bool = True,
    max_segments: int | None = None,
) -> dict[str, torch.Tensor]:
    """Run (or resume) a checkpointed joint search on ``leaf_tensor``'s
    device; returns the final params.

    ``max_segments`` bounds how many checkpoint segments this call runs
    (None: to completion); a later call with ``resume`` picks up where it
    stopped. The initial parameters are drawn from a generator seeded with
    ``cfg.seed``.
    """
    device = leaf_tensor.device
    n_all, length, n_states = leaf_tensor.shape
    generator = torch.Generator(device).manual_seed(cfg.seed)
    params = {
        k: v.requires_grad_(True)
        for k, v in init_params((n_all + 1) // 2, length, n_states, generator=generator).items()
    }
    optimizer = make_optimizer(
        cfg.joint.optimizer, cfg.joint.learning_rate, params.values(),
        clip_global_norm=cfg.joint.clip_global_norm, batched=is_batched(params),
    )
    step = 0
    ckpt_root = os.path.join(cfg.workdir, "checkpoints")
    latest = latest_step_dir(ckpt_root) if resume else None
    if latest is not None:
        restored = restore_checkpoint(latest, map_location=device)
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(restored["params"][k])
        optimizer.load_state_dict(restored["opt_state"])
        step = int(restored["step"])

    loss = joint_loss_fn(leaf_tensor, cfg.joint)
    shape = params["tree_params"].shape
    segments_done = 0
    with MetricsLogger(os.path.join(cfg.workdir, "metrics.jsonl"), echo=False) as log:
        while step < cfg.n_iterations and (max_segments is None or segments_done < max_segments):
            n_steps = min(cfg.checkpoint_every, cfg.n_iterations - step)
            steps = torch.arange(step, step + n_steps, device=device)

            def noise_at(i, start=step):
                generator.manual_seed(step_seed(cfg.seed, start + i))
                return gumbel(shape, generator=generator)

            losses = run_steps(params, optimizer, loss, anneal(cfg.joint, steps, cfg.n_iterations),
                               noise_at, cfg.joint)
            step += n_steps
            log.log(step, loss=float(losses[-1]), segment_mean=float(losses.mean()))
            save_checkpoint(
                os.path.join(ckpt_root, f"step_{step}"),
                {"params": {k: v.detach() for k, v in params.items()},
                 "opt_state": optimizer.state_dict(), "step": step},
            )
            segments_done += 1
    return {k: v.detach() for k, v in params.items()}
