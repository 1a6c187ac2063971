"""The ``bench`` command (counterpart of ``cmd_bench`` in
``trex_tpu/cli/search_cmds.py``): batched candidate-scoring throughput of
``ops.dispatch.batched_scores_fastest`` on random trees — K1 for Hamming
with at most 32 states, K5 above (``--states 61``, the codon alphabet)."""

from __future__ import annotations

import json

import torch

from trex_tpu_torch._device import resolve_device


def bench_inputs(args, device: torch.device):
    """(topologies, cost, leaves) of a ``bench`` run: ``--batch`` random
    trees (``random_topologies(--seed)``, the JAX command's trees), the
    Hamming cost and uniform int32 leaf states drawn from ``--seed + 1``."""
    from trex_tpu_torch.topology import random_topologies
    from trex_tpu_torch.types import CostModel

    topos = random_topologies(args.seed, args.leaves, args.batch, device)
    cost = CostModel.hamming(args.states, device=device).matrix
    generator = torch.Generator().manual_seed(args.seed + 1)
    leaves = torch.randint(
        0, args.states, (args.leaves, args.sites), generator=generator, dtype=torch.int32
    )
    return topos, cost, leaves.to(device)


def run_bench(args) -> tuple[dict, torch.Tensor]:
    """The printed JSON object of ``bench`` and the batch's (B,) scores."""
    from trex_tpu_torch.ops.dispatch import batched_scores_fastest
    from trex_tpu_torch.utils.profiling import timed

    device = resolve_device(args.device)
    topos, cost, leaves = bench_inputs(args, device)
    mean_s, scores = timed(
        batched_scores_fastest, topos, cost, leaves, device=device, reps=args.reps
    )
    out = {
        "metric": f"tree evals/s ({args.leaves} taxa, {args.sites} sites)",
        "value": round(args.batch / mean_s, 1),
        "unit": "trees/s",
        "batch": args.batch,
        "ms_per_batch": round(mean_s * 1e3, 3),
    }
    return out, scores


def cmd_bench(args) -> None:
    print(json.dumps(run_bench(args)[0]))
