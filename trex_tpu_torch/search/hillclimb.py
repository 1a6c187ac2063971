"""Discrete parsimony hill climbing (counterpart of ``trex_tpu/search/hillclimb.py``).

Two neighborhoods:

- ``"spr-scan"``: each round is one analytic all-SPR scan
  (``ops.spr_scan``) — no candidate trees are built; the best move is
  applied on the host with ``io.spr_move``;
- ``"nni"``: the host enumerates the 2(n-2) NNI neighbors and the device
  scores the whole batch in one call (``ops.dispatch``): on the card K1
  for a Hamming cost with at most 32 states, K5 (min-plus Sankoff) for any
  other cost matrix — weighted parsimony, e.g.
  ``CostModel.transition_transversion(1, 2)`` on integer DNA states.

Both stop at a local optimum or after ``max_rounds`` rounds. Unlike the
JAX package's default NNI scorer, the port's honours ``site_weights`` and
``sequences_are_masks``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from trex_tpu_torch._device import resolve_device
from trex_tpu_torch.topology import Topology


@dataclasses.dataclass
class SearchResult:
    topology: Topology
    score: float
    rounds: int
    evaluations: int
    trace: list[float]


def parsimony_hill_climb(
    start: Topology,
    cost_matrix: torch.Tensor,
    leaf_sequences,
    *,
    max_rounds: int = 100,
    neighborhood: str = "nni",
    site_weights=None,
    sequences_are_masks: bool = False,
    score_batch_fn=None,
    device=None,
) -> SearchResult:
    """Greedy hill climb from ``start``; stops at a local optimum.

    Args:
        start: starting topology (moved to the climb's device).
        cost_matrix: (Q, Q) ``cost[parent_state, child_state]``; the
            ``"nni"`` scorer picks its kernel from it (``ops.dispatch``).
        leaf_sequences: (n_leaves, L) states or masks, a tensor or a numpy
            array of any integer type (the kernels get int32).
        neighborhood: ``"nni"`` (candidates scored by
            ``ops.dispatch.batched_scores_fastest`` with ``site_weights``
            and ``sequences_are_masks``; the batch carries a broadcast
            ``parents`` placeholder, since scoring reads ``children`` only)
            or ``"spr-scan"`` (unit cost only). ``"spr"`` and ``"tbr"``
            wait for a later slice.
        score_batch_fn: optional ``(topologies, cost_matrix, leaves) ->
            (B,) scores`` (lower is better) that replaces the parsimony
            scorer of the ``"nni"`` neighborhood — the ML climb's hook.
        device: where the climb runs; default the device of a tensor
            ``leaf_sequences``, else ``cuda``.
    """
    from trex_tpu_torch.ops.dispatch import batched_scores_fastest

    if device is None and torch.is_tensor(leaf_sequences):
        device = leaf_sequences.device
    device = resolve_device("cuda" if device is None else device)
    leaves = torch.as_tensor(leaf_sequences, device=device)
    weights = (
        None if site_weights is None
        else torch.as_tensor(site_weights, device=device).to(torch.float32)
    )
    start = start.to(device)

    if neighborhood == "spr-scan":
        if score_batch_fn is not None:
            raise ValueError(
                "spr-scan evaluates candidates analytically; a custom "
                "score_batch_fn is not supported"
            )
        return _spr_scan_climb(
            start, leaves, max_rounds,
            site_weights=weights,
            sequences_are_masks=sequences_are_masks,
        )
    if neighborhood != "nni":
        raise NotImplementedError(
            f"neighborhood {neighborhood!r} is not ported yet (spr/tbr need "
            "the enumerating generators of a later slice; see ROADMAP.md)"
        )
    from trex_tpu_torch.io import nni_neighbors_host
    from trex_tpu_torch.topology import from_numpy

    def score_batch(topos: Topology):
        if score_batch_fn is not None:
            return score_batch_fn(topos, cost_matrix, leaves)
        return batched_scores_fastest(
            topos, cost_matrix, leaves, weights,
            sequences_are_masks=sequences_are_masks,
        )

    def single_score(topo: Topology) -> float:
        return float(score_batch(Topology(topo.children[None], topo.parents[None]))[0])

    current = start
    current_score = single_score(current)
    trace = [current_score]
    evaluations = 1
    n_all = start.n_all
    for round_idx in range(max_rounds):
        nbr_children, nbr_parents = nni_neighbors_host(current)
        n_real = int(nbr_children.shape[0])
        batch = Topology(
            children=torch.as_tensor(nbr_children, device=device),
            parents=torch.as_tensor(nbr_parents[0], device=device).expand(
                n_real, n_all
            ),
        )
        scores = score_batch(batch).cpu().numpy()
        evaluations += n_real
        best = int(scores.argmin())
        if scores[best] >= current_score:
            return SearchResult(
                current, current_score, round_idx, evaluations, trace
            )
        current = from_numpy(nbr_children[best], nbr_parents[best], device)
        current_score = float(scores[best])
        trace.append(current_score)
    return SearchResult(current, current_score, max_rounds, evaluations, trace)


def _spr_scan_climb(
    start: Topology,
    leaf_sequences: torch.Tensor,
    max_rounds: int,
    *,
    site_weights: torch.Tensor | None,
    sequences_are_masks: bool,
) -> SearchResult:
    """Hill climb where each round is one analytic all-SPR scan.

    ``evaluations`` counts scored candidates (finite scan entries) for
    comparability with the enumerating climber.
    """
    from trex_tpu_torch.io import spr_move
    from trex_tpu_torch.ops.spr_scan import spr_scan_best_segmented
    from trex_tpu_torch.utils.chunking import auto_prune_chunk, scan_budget_bytes

    n_all = start.n_all
    length = leaf_sequences.shape[-1]
    # Bound each chunk's (chunk x nodes x sites) up/down tables.
    prune_chunk = auto_prune_chunk(
        n_all - 1, n_all * length * 4 * 2, scan_budget_bytes(leaf_sequences.device)
    )

    def run_scan(topo):
        return spr_scan_best_segmented(
            topo, leaf_sequences, site_weights,
            sequences_are_masks=sequences_are_masks,
            prune_chunk=prune_chunk,
        )

    current = start
    best, p, v, base, n_finite = run_scan(current)
    current_score = float(base)
    trace = [current_score]
    evaluations = 1
    for round_idx in range(max_rounds):
        evaluations += n_finite
        if best >= current_score:
            return SearchResult(
                current, current_score, round_idx, evaluations, trace
            )
        moved = spr_move(current, p, v)
        if moved is None:  # defensive; scan-valid moves are spr_move-valid
            return SearchResult(
                current, current_score, round_idx, evaluations, trace
            )
        current, current_score = moved, best
        trace.append(current_score)
        best, p, v, _, n_finite = run_scan(current)
    return SearchResult(current, current_score, max_rounds, evaluations, trace)
