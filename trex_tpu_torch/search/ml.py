"""Maximum-likelihood tree search (counterpart of ``ml_hill_climb`` in
``trex_tpu/search/ml.py``).

Candidates are ranked by pruning log-likelihood with every branch fixed at
one length (the standard fast heuristic); the winner's branch lengths are
then fitted by damped Newton sweeps (``ops.likelihood_asr``) or by Adam.
"""

from __future__ import annotations

import time

import torch

from trex_tpu_torch._device import resolve_device
from trex_tpu_torch.ops.likelihood import _f32, fixed_length_model, optimize_branch_lengths
from trex_tpu_torch.ops.likelihood_asr import optimize_branch_lengths_newton
from trex_tpu_torch.ops.likelihood_cuda import batched_log_likelihood_cuda
from trex_tpu_torch.search.hillclimb import SearchResult, parsimony_hill_climb
from trex_tpu_torch.topology import Topology


def ml_hill_climb(
    start: Topology,
    leaf_sequences,
    n_states: int,
    *,
    ranking_branch_length: float = 0.1,
    max_rounds: int = 50,
    neighborhood: str = "spr",
    optimize_final_lengths: bool = True,
    length_optimizer: str = "newton",
    sequences_are_masks: bool = False,
    site_weights=None,
    rates=None,
    freqs=None,
    gamma_shape=None,
    category_rates=None,
    category_weights=None,
    n_length_iterations: int = 400,
    device=None,
    timings: dict | None = None,
) -> tuple[SearchResult, torch.Tensor, torch.Tensor]:
    """Greedy ML topology search, then the branch-length fit.

    Candidates are ranked by log-likelihood with every branch at
    ``ranking_branch_length`` (negated: the climber minimises).
    ``neighborhood="nni"``, ``"spr"`` or ``"tbr"`` scores each round's
    enumerated neighbours (the native move library) in one call of
    ``ops.likelihood_cuda.batched_log_likelihood_cuda`` (K3/K4 on the card)
    against one shared transition matrix; ``"spr-scan"`` evaluates the
    whole SPR neighbourhood analytically per round
    (``ops.likelihood_scan``), exact for the same all-fixed-length
    candidates. ``rates``/``freqs``: optional GTR model (JC69 otherwise).
    ``gamma_shape`` (+G) or ``category_rates``/``category_weights``
    (FreeRate; +I as a rate-0 class): mixture-aware ranking, ``"spr-scan"``
    only (the kernel returns site sums, which cannot be mixed per site).
    ``sequences_are_masks``: leaves are int32 state-set bitmasks.
    ``site_weights``: per-site multiplicities (compressed patterns).
    ``length_optimizer``: ``"newton"`` (damped analytic Newton sweeps) or,
    on the enumerating neighbourhoods, ``"adam"`` (``n_length_iterations``
    steps of ``ops.likelihood.optimize_branch_lengths``); the scan
    neighbourhood always fits by Newton, as the reference does.
    ``device``: where the search runs; default the device of a tensor
    ``leaf_sequences``, else ``cuda``. ``timings``: a dict that, when
    given, receives the wall seconds of the climb (``"climb"``) and of the
    branch-length fit (``"newton"``), each taken after the device is done.

    Returns (search_result, branch_lengths (n_all,), nll_curve): the
    result's ``score`` is the negative ranking log-likelihood; the lengths
    are the fitted ones (the fixed ones when ``optimize_final_lengths`` is
    False, with the curve holding the ranking score alone).
    """
    if (gamma_shape is not None or category_rates is not None) and neighborhood != "spr-scan":
        raise ValueError("rate-mixture-aware ranking needs neighborhood='spr-scan'")
    if neighborhood not in ("nni", "spr", "tbr", "spr-scan"):
        raise ValueError(f"unknown neighborhood {neighborhood!r}")
    if length_optimizer not in ("newton", "adam"):
        raise ValueError(f"unknown length_optimizer {length_optimizer!r}")
    if device is None and torch.is_tensor(leaf_sequences):
        device = leaf_sequences.device
    device = resolve_device("cuda" if device is None else device)
    leaves = torch.as_tensor(leaf_sequences, device=device).to(torch.int32).contiguous()
    length = leaves.shape[-1]
    weights = (
        torch.ones((length,), dtype=torch.float32, device=device)
        if site_weights is None else _f32(site_weights, device=device).contiguous()
    )
    start = start.to(device)
    n_all = start.n_all
    t0 = time.perf_counter()

    if neighborhood == "spr-scan":
        result = _ml_scan_climb(
            start, leaves, n_states,
            ranking_branch_length=ranking_branch_length, max_rounds=max_rounds,
            site_weights=weights, sequences_are_masks=sequences_are_masks,
            rates=rates, freqs=freqs, gamma_shape=gamma_shape,
            category_rates=category_rates, category_weights=category_weights,
        )
    else:
        # Every ranking branch has the same length, so one (Q, Q) matrix
        # serves the whole batch.
        shared, prior = fixed_length_model(
            n_states, ranking_branch_length, rates, freqs, device
        )
        shared, prior = shared.contiguous(), prior.contiguous()

        def score_batch(topos, _cost, _leaves):
            children = topos.children.to(torch.int32).contiguous()
            return -batched_log_likelihood_cuda(
                children, leaves, weights, prior, shared,
                sequences_are_masks=sequences_are_masks,
            )

        result = parsimony_hill_climb(  # the generic greedy climber, ML objective
            start, torch.zeros((n_states, n_states), device=device), leaves,
            max_rounds=max_rounds, neighborhood=neighborhood,
            score_batch_fn=score_batch, device=device,
        )

    _sync(device)
    t1 = time.perf_counter()
    if not optimize_final_lengths:
        lengths = torch.full((n_all,), float(ranking_branch_length), device=device)
        losses = torch.tensor([result.score], device=device)
    elif length_optimizer == "adam" and neighborhood != "spr-scan":
        lengths, losses = optimize_branch_lengths(
            result.topology, leaves, n_states, init_length=ranking_branch_length,
            n_iterations=n_length_iterations, rates=rates, freqs=freqs,
            sequences_are_masks=sequences_are_masks, site_weights=weights,
        )
        _sync(device)
    else:
        lengths, losses = optimize_branch_lengths_newton(
            result.topology, leaves, n_states, rates, freqs,
            site_weights=weights, sequences_are_masks=sequences_are_masks,
            init_length=ranking_branch_length,
        )
        _sync(device)
    if timings is not None:
        timings["climb"] = t1 - t0
        timings["newton"] = time.perf_counter() - t1
    return result, lengths, losses


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _ml_scan_climb(
    start: Topology,
    leaves: torch.Tensor,
    n_states: int,
    *,
    ranking_branch_length: float,
    max_rounds: int,
    site_weights: torch.Tensor,
    sequences_are_masks: bool,
    rates=None,
    freqs=None,
    gamma_shape=None,
    category_rates=None,
    category_weights=None,
) -> SearchResult:
    """Greedy ML climb where each round is one analytic likelihood scan
    (rate-mixture aware with ``gamma_shape`` or ``category_rates``).

    ``evaluations`` counts scored candidates (finite scan entries).
    """
    from trex_tpu_torch.io import spr_move
    from trex_tpu_torch.ops.likelihood_scan import likelihood_spr_scan_best_segmented
    from trex_tpu_torch.utils.chunking import auto_prune_chunk, scan_budget_bytes

    n_all = start.n_all
    length = leaves.shape[-1]
    # Each prune variant holds (Q+1)-wide f32 inside and upstream tables,
    # and under a mixture one (n_all, L) f32 per-site table a category until
    # the categories are mixed.
    if category_rates is not None:
        n_cat = len(category_rates)
    elif gamma_shape is not None:
        n_cat = 4
    else:
        n_cat = 0
    prune_chunk = auto_prune_chunk(
        n_all - 1, n_all * length * 4 * ((n_states + 1) * 2 + n_cat),
        scan_budget_bytes(leaves.device),
    )

    def run_scan(topo):
        return likelihood_spr_scan_best_segmented(
            topo, leaves, n_states, ranking_branch_length, site_weights,
            rates=rates, freqs=freqs, gamma_shape=gamma_shape,
            category_rates=category_rates, category_weights=category_weights,
            sequences_are_masks=sequences_are_masks, prune_chunk=prune_chunk,
        )

    current = start
    best, p, v, base, n_finite = run_scan(current)
    current_score = float(base)
    trace = [current_score]
    evaluations = 1
    for round_idx in range(max_rounds):
        evaluations += n_finite
        if best >= current_score:
            return SearchResult(current, current_score, round_idx, evaluations, trace)
        moved = spr_move(current, p, v)
        if moved is None:
            return SearchResult(current, current_score, round_idx, evaluations, trace)
        current, current_score = moved, best
        trace.append(current_score)
        best, p, v, _, n_finite = run_scan(current)
    return SearchResult(current, current_score, max_rounds, evaluations, trace)
