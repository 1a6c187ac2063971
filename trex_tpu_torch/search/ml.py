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
    constraint_splits: list[frozenset[int]] | None = None,
    constraint_taxa: frozenset[int] | None = None,
    device=None,
    timings: dict | None = None,
    mesh=None,
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
    ``constraint_splits``/``constraint_taxa``: splits every visited tree
    keeps (``parsimony_hill_climb``'s filter), enumerating neighbourhoods
    only. ``device``: where the search runs; default the device of a tensor
    ``leaf_sequences``, else ``cuda``. ``timings``: a dict that, when
    given, receives the wall seconds of the climb (``"climb"``) and of the
    branch-length fit (``"newton"``), each taken after the device is done.
    ``mesh``: an optional ('tree', 'site') ``parallel.mesh.Mesh`` (every
    rank runs the search with the same inputs); with ``"spr-scan"`` each
    round's scan splits its prune rows over ``tree`` and reduces them to
    the best move (``parallel.sharded.sharded_spr_scan_best``). The
    enumerating neighbourhoods rank on each rank's device alone, as the
    JAX package's do.

    Returns (search_result, branch_lengths (n_all,), nll_curve): the
    result's ``score`` is the negative ranking log-likelihood; the lengths
    are the fitted ones (the fixed ones when ``optimize_final_lengths`` is
    False, with the curve holding the ranking score alone).
    """
    if (gamma_shape is not None or category_rates is not None) and neighborhood != "spr-scan":
        raise ValueError("rate-mixture-aware ranking needs neighborhood='spr-scan'")
    if constraint_splits and neighborhood == "spr-scan":
        raise ValueError(
            "constrained ML search needs an enumerating neighborhood (nni/spr/tbr), not spr-scan"
        )
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
            mesh=mesh,
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
            score_batch_fn=score_batch, constraint_splits=constraint_splits,
            constraint_taxa=constraint_taxa, device=device,
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
    mesh=None,
) -> SearchResult:
    """Greedy ML climb where each round is one analytic likelihood scan
    (rate-mixture aware with ``gamma_shape`` or ``category_rates``), its
    prune rows over ``mesh``'s ``tree`` axis (None: this device alone).

    ``evaluations`` counts scored candidates (finite scan entries).
    """
    from trex_tpu_torch.io import spr_move
    from trex_tpu_torch.parallel.sharded import sharded_spr_scan_best

    def run_scan(topo):
        return sharded_spr_scan_best(
            mesh, topo, leaves, site_weights, sequences_are_masks=sequences_are_masks,
            criterion="ml", ranking_branch_length=ranking_branch_length,
            n_states=n_states, rates=rates, freqs=freqs, gamma_shape=gamma_shape,
            category_rates=category_rates, category_weights=category_weights,
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


def ml_iterated_search(
    start: Topology,
    leaf_sequences,
    n_states: int,
    *,
    seed: int,
    n_iterations: int = 10,
    perturb_moves: int = 3,
    stop_after: int = 5,
    ranking_branch_length: float = 0.1,
    max_rounds: int = 50,
    neighborhood: str = "spr-scan",
    sequences_are_masks: bool = False,
    site_weights=None,
    rates=None,
    freqs=None,
    progress_dir: str | None = None,
    device=None,
    timings: dict | None = None,
    mesh=None,
) -> tuple[SearchResult, torch.Tensor, torch.Tensor]:
    """Iterated ML search: random kicks and a reclimb, keeping the best.

    The ML counterpart of the parsimony ratchet: each iteration applies
    ``perturb_moves`` random moves (SPR and TBR in turn, the host move
    library) to the incumbent, reclimbs with ``ml_hill_climb`` (under
    ``rates``/``freqs`` when given) and keeps the best ranking score seen;
    it stops after ``stop_after`` iterations in a row without a gain. The
    kicks come from ``np.random.default_rng(seed)``: the JAX package draws
    from ``default_rng(key_data(key)[-1])``, so its key
    ``PRNGKey(seed)`` replays exactly.

    ``progress_dir``: the best tree so far (``best.nwk``, leaves named
    ``L<i>``) and the score trace (``trace.jsonl``, appended) are written
    after every iteration; a ``best.nwk`` already there replaces ``start``
    (the search resumes from it). ``timings``: a dict that, when given,
    receives the wall seconds of the first climb (``"climb"``), of each
    reclimb (``"reclimbs"``, a list) and of the final Newton fit
    (``"newton"``), each after the device is done. ``mesh``: passed to
    every ``ml_hill_climb``.

    Returns (best result, its Newton-fitted branch lengths, loss curve):
    the result's ``trace`` holds the best score after each iteration.
    """
    import json
    import os

    import numpy as np

    from trex_tpu_torch.io import load_newick, renumber_leaves, save_newick
    from trex_tpu_torch.io import spr_move_host, tbr_move_host
    from trex_tpu_torch.topology import from_numpy

    if device is None and torch.is_tensor(leaf_sequences):
        device = leaf_sequences.device
    device = resolve_device("cuda" if device is None else device)
    leaves = torch.as_tensor(leaf_sequences, device=device)
    if progress_dir is not None:
        best_path = os.path.join(progress_dir, "best.nwk")
        if os.path.exists(best_path):
            # Resume: leaves were saved under their index names (L<i>).
            with open(best_path) as fh:
                saved, _, names = load_newick(fh.read())
            ids = [int(n[1:]) if n.startswith("L") else int(n) for n in names]
            start = renumber_leaves(saved, ids)
    start = start.to(device)
    rng = np.random.default_rng(seed)
    climb_kwargs = dict(
        ranking_branch_length=ranking_branch_length, max_rounds=max_rounds,
        neighborhood=neighborhood, optimize_final_lengths=False,
        sequences_are_masks=sequences_are_masks, site_weights=site_weights,
        rates=rates, freqs=freqs, device=device, mesh=mesh,
    )

    def dump_progress(iteration: int, best: SearchResult) -> None:
        if progress_dir is None:
            return
        os.makedirs(progress_dir, exist_ok=True)
        with open(os.path.join(progress_dir, "best.nwk"), "w") as fh:
            fh.write(save_newick(best.topology) + "\n")
        with open(os.path.join(progress_dir, "trace.jsonl"), "a") as fh:
            fh.write(json.dumps({"iteration": iteration, "score": best.score}) + "\n")

    clock = time.perf_counter()
    best, _, _ = ml_hill_climb(start, leaves, n_states, **climb_kwargs)
    _sync(device)
    reclimbs: list[float] = []
    first = time.perf_counter() - clock
    trace = [best.score]
    evaluations = best.evaluations
    n_all = start.n_all
    stale = 0
    dump_progress(0, best)
    for _ in range(n_iterations):
        if stale >= stop_after:
            break
        children_np, parents_np = best.topology.to_numpy()
        applied = 0
        while applied < perturb_moves:
            prune = int(rng.integers(0, n_all - 1))
            regraft = int(rng.integers(0, n_all - 1))
            reroot = int(rng.integers(0, n_all))
            if applied % 2 == 0:
                moved = spr_move_host(children_np, prune, regraft)
            else:
                moved = tbr_move_host(children_np, prune, reroot, regraft)
            if moved is None:
                continue
            children_np, parents_np = moved
            applied += 1
        clock = time.perf_counter()
        attempt, _, _ = ml_hill_climb(from_numpy(children_np, parents_np, device), leaves,
                                      n_states, **climb_kwargs)
        _sync(device)
        reclimbs.append(time.perf_counter() - clock)
        evaluations += attempt.evaluations
        if attempt.score < best.score - 1e-6:
            best = attempt
            stale = 0
        else:
            stale += 1
        trace.append(best.score)
        dump_progress(len(trace) - 1, best)
    clock = time.perf_counter()
    lengths, losses = optimize_branch_lengths_newton(
        best.topology, leaves, n_states, rates, freqs,
        site_weights=None if site_weights is None else _f32(site_weights, device=device),
        sequences_are_masks=sequences_are_masks, init_length=ranking_branch_length,
    )
    _sync(device)
    if timings is not None:
        timings.update(climb=first, reclimbs=reclimbs, newton=time.perf_counter() - clock)
    return SearchResult(best.topology, best.score, len(trace) - 1, evaluations, trace), \
        lengths, losses


def ml_partitioned_scan_climb(
    start: Topology,
    partitions: list[dict],
    n_states: int,
    *,
    ranking_branch_length: float = 0.1,
    max_rounds: int = 50,
    sequences_are_masks: bool = False,
    timings: dict | None = None,
) -> SearchResult:
    """Greedy ML climb under a partitioned model through summed analytic
    scans.

    The partitioned log-likelihood is the sum of the partitions', so the
    joint model's all-SPR ranking table is the elementwise sum of each
    partition's scan (``ops.likelihood_scan.likelihood_spr_scan_segmented``
    under its own ``rates``/``freqs``/``gamma_shape``, its
    ``rate_multiplier`` scaling the shared ranking length). The sum stays
    on the device and is reduced there: the move is the first minimum of
    the flattened table, as ``np.argmin`` of it picks, and only scalars
    reach the host.

    Args:
        partitions: one dict a partition with ``leaf_sequences`` ((n, L_p)
            states or masks on the climb's device) and optional
            ``site_weights``, ``rates``, ``freqs``, ``gamma_shape`` and
            ``rate_multiplier`` (default 1.0).
        timings: a dict that, when given, receives the wall seconds of
            each round's summed scan (``"scan_rounds"``, a list).

    Returns a ``SearchResult`` whose score is the summed negative ranking
    log-likelihood.
    """
    from trex_tpu_torch.io import spr_move
    from trex_tpu_torch.ops.likelihood_scan import likelihood_spr_scan_segmented
    from trex_tpu_torch.utils.chunking import auto_prune_chunk, scan_budget_bytes

    device = torch.as_tensor(partitions[0]["leaf_sequences"]).device
    start = start.to(device)
    n_all = start.n_all
    scan_walls: list[float] = []

    def all_scores(topo):
        clock = time.perf_counter()
        total = None
        base_total = 0.0
        for part in partitions:
            leaf = torch.as_tensor(part["leaf_sequences"])
            prune_chunk = auto_prune_chunk(
                n_all - 1, n_all * leaf.shape[-1] * (n_states + 1) * 4 * 2,
                scan_budget_bytes(device),
            )
            scores, base = likelihood_spr_scan_segmented(
                topo, leaf, n_states,
                ranking_branch_length * float(part.get("rate_multiplier", 1.0)),
                part.get("site_weights"), rates=part.get("rates"), freqs=part.get("freqs"),
                gamma_shape=part.get("gamma_shape"), sequences_are_masks=sequences_are_masks,
                prune_chunk=prune_chunk,
            )
            total = scores if total is None else total + scores
            base_total += float(base)
        flat = total.reshape(-1)
        idx = torch.argmin(flat)
        best, idx, n_finite = float(flat[idx]), int(idx), int(torch.isfinite(flat).sum())
        scan_walls.append(time.perf_counter() - clock)
        return best, divmod(idx, n_all), n_finite, base_total

    current = start
    best, (p, v), n_finite, current_score = all_scores(current)
    trace = [current_score]
    evaluations = 1
    result = None
    for round_idx in range(max_rounds):
        evaluations += n_finite
        if best >= current_score:
            result = SearchResult(current, current_score, round_idx, evaluations, trace)
            break
        moved = spr_move(current, p, v)
        if moved is None:
            result = SearchResult(current, current_score, round_idx, evaluations, trace)
            break
        current, current_score = moved, best
        trace.append(current_score)
        best, (p, v), n_finite, _ = all_scores(current)
    if result is None:
        result = SearchResult(current, current_score, max_rounds, evaluations, trace)
    if timings is not None:
        timings["scan_rounds"] = scan_walls
    return result
