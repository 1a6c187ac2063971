"""File-based tree inference: the ``infer`` command's parsimony and ML
branches (counterpart of ``trex_tpu/cli/infer.py``)."""

from __future__ import annotations

import dataclasses
import json
import time

import torch

from trex_tpu_torch._device import resolve_device
from trex_tpu_torch.cli._common import _load_alignment, _start_tree
from trex_tpu_torch.search.hillclimb import SearchResult

# Flags of the JAX ``infer`` that this port does not cover yet, with the
# value that means "not requested" and the slice that adds them.
_NOT_PORTED = (
    ("ratchet", 0, "slice 1b (parsimony ratchet)"),
    ("bootstrap", 0, "slice 1b (supports)"),
    ("decay", False, "slice 1b (SPR-decay support)"),
    ("outgroup", None, "slice 1b (rerooting)"),
    ("constraint", None, "slice 1b (constrained search)"),
    ("model", "jc", "slice 2 item 7 (model fitting: optimize_model)"),
    ("model_file", None, "slice 2 item 7 (model fitting: optimize_model)"),
    ("model_rounds", 0, "slice 2 item 7 (model fitting: optimize_model)"),
    ("alrt", 0, "queue A item 13 (supports)"),
    ("ufboot", 0, "queue A item 13 (supports)"),
)


@dataclasses.dataclass
class InferRun:
    out: dict
    """The printed JSON object."""
    result: SearchResult
    seconds: dict[str, float]
    """Wall seconds of the starting trees ("start"), the climbs ("climb")
    and, for ``--criterion ml``, the branch-length fits ("newton")."""
    lengths: torch.Tensor | None = None
    """The fitted branch lengths (``--criterion ml``)."""


def _check_ported(args) -> None:
    if args.criterion == "distance":
        raise SystemExit(
            "--criterion distance is not ported yet: slice 2b of ROADMAP.md "
            "(NJ/UPGMA, item 9)"
        )
    for name, unset, where in _NOT_PORTED:
        if getattr(args, name) != unset:
            raise SystemExit(
                f"--{name} is not ported yet: {where} of ROADMAP.md"
            )
    if args.neighborhood not in ("spr-scan", "nni"):
        raise SystemExit(
            f"--neighborhood {args.neighborhood} is not ported yet: slice 1b "
            "of ROADMAP.md (enumerating SPR/TBR generators)"
        )
    if args.mesh not in (None, "1,1"):
        raise SystemExit(
            "--mesh is not ported yet: multi-device search is queue A item 15 "
            "of ROADMAP.md; this port runs on one device"
        )


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_infer(args) -> InferRun:
    """FASTA in, inferred tree out: stepwise start trees, then a parsimony
    or (``--criterion ml``) likelihood climb."""
    import numpy as np

    from trex_tpu_torch.alignment import compress_alignment
    from trex_tpu_torch.io import save_newick
    from trex_tpu_torch.search.hillclimb import parsimony_hill_climb
    from trex_tpu_torch.types import CostModel

    _check_ported(args)
    device = resolve_device(args.device)
    names, masks, n_states = _load_alignment(args.fasta, args.alphabet)
    patterns, counts = compress_alignment(masks)
    patterns = np.asarray(patterns, dtype=np.int32)
    weights = torch.as_tensor(counts, dtype=torch.float32, device=device)

    out: dict[str, object] = {
        "criterion": args.criterion,
        "start": args.start,
        "n_taxa": len(names),
        "n_sites": int(masks.shape[1]),
        "unique_patterns": int((counts > 0).sum()),
    }
    t0 = time.perf_counter()
    # The --start tree plus (--restarts - 1) more random-addition-order starts.
    starts = [
        _start_tree(
            args.start, patterns, n_states, args.seed + 1000 * r, weights,
            args.orders, device,
        )
        for r in range(max(args.restarts, 1))
    ]
    _sync(device)
    t1 = time.perf_counter()
    if args.restarts > 1:
        out["restarts"] = args.restarts

    leaves = torch.as_tensor(patterns, device=device)
    if args.criterion == "ml":
        return _run_ml(args, out, names, leaves, n_states, weights, starts, t1 - t0)
    cost = CostModel.hamming(n_states, device=device).matrix
    result = None
    for st in starts:
        attempt = parsimony_hill_climb(
            st, cost, leaves,
            max_rounds=args.rounds,
            neighborhood=args.neighborhood,
            site_weights=weights,
            sequences_are_masks=True,
        )
        if result is None or attempt.score < result.score:
            result = attempt
    _sync(device)
    t2 = time.perf_counter()
    out["parsimony_score"] = result.score
    _finish(args, out, result, save_newick(result.topology, names))
    return InferRun(out, result, {"start": t1 - t0, "climb": t2 - t1})


def _finish(args, out: dict, result: SearchResult, newick: str) -> None:
    out.update(
        search_rounds=result.rounds,
        evaluations=result.evaluations,
        tree=newick,
    )
    if args.output_tree:
        with open(args.output_tree, "w") as fh:
            fh.write(newick + "\n")


def _run_ml(args, out, names, leaves, n_states, weights, starts, start_seconds) -> InferRun:
    """The ML branch: a likelihood climb from each start, then the Newton
    branch-length fit; the start with the lowest fitted NLL wins."""
    from trex_tpu_torch.io import save_newick
    from trex_tpu_torch.search.ml import ml_hill_climb

    seconds = {"start": start_seconds, "climb": 0.0, "newton": 0.0}
    best = None
    for st in starts:
        timings: dict[str, float] = {}
        # Compressed patterns + weights are exact for ML too: the total
        # log-likelihood is a weighted per-site sum.
        result, lengths, losses = ml_hill_climb(
            st, leaves, n_states,
            max_rounds=args.rounds,
            neighborhood=args.neighborhood,
            sequences_are_masks=True,
            site_weights=weights,
            timings=timings,
        )
        seconds["climb"] += timings["climb"]
        seconds["newton"] += timings["newton"]
        if best is None or float(losses[-1]) < float(best[2][-1]):
            best = (result, lengths, losses)
    result, lengths, losses = best
    out.update(
        neg_log_likelihood=float(losses[-1]),
        ranking_score=result.score,
        model=args.model,
    )
    lengths_np = lengths.cpu().numpy()
    out["mean_branch_length"] = float(lengths_np.mean())
    _finish(args, out, result, save_newick(result.topology, names, lengths_np))
    return InferRun(out, result, seconds, lengths)


def cmd_infer(args) -> None:
    print(json.dumps(run_infer(args).out))
