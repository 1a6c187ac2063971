"""Discrete parsimony hill climbing (counterpart of ``trex_tpu/search/hillclimb.py``).

Neighborhoods:

- ``"spr-scan"``: each round is one analytic all-SPR scan
  (``ops.spr_scan``) — no candidate trees are built; the best move is
  applied on the host with ``io.spr_move``;
- ``"nni"``, ``"spr"`` and ``"tbr"``: the host enumerates the candidates
  (the port's native library, ``io.native``, or its Python fallback) and
  the device scores the whole batch in one call (``ops.dispatch``): on
  the card K1 for a Hamming cost with at most 32 states, K5 (min-plus
  Sankoff) for any other cost matrix — weighted parsimony, e.g.
  ``CostModel.transition_transversion(1, 2)`` on integer DNA states.
  ``"tbr"`` samples ``tbr_budget`` candidates a round; random SPR/TBR
  kicks and constraint splits apply to these three.

Each stops at a local optimum or after ``max_rounds`` rounds. Unlike the
JAX package's default enumerating scorer, the port's honours
``site_weights`` and ``sequences_are_masks``. The JAX package pads each
candidate batch to a size bucket for XLA's compile cache; K1's scores do
not depend on the batch size, so the port scores the batch as it is.
"""

from __future__ import annotations

import dataclasses
import time

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


def _clade_hash_batch(children_batch: np.ndarray, n_leaves: int, salt: np.ndarray) -> np.ndarray:
    """(B, n_all) additive clade hashes: hash(node) = the sum of its leaves'
    salts (uint64 wraparound); disjoint leaf sets give distinct sums with
    high probability."""
    b, n_anc, _ = children_batch.shape
    h = np.zeros((b, n_leaves + n_anc), np.uint64)
    h[:, :n_leaves] = salt[None, :]
    rows = np.arange(b)
    for a in range(n_anc):
        h[:, n_leaves + a] = h[rows, children_batch[:, a, 0]] + h[rows, children_batch[:, a, 1]]
    return h


def constraint_mask(
    required_splits: list[frozenset[int]],
    n_leaves: int,
    constraint_taxa: frozenset[int] | None = None,
):
    """Candidate filter for constrained search (IQ-TREE ``-g``).

    Returns ``fn(children_batch (B, n_anc, 2) numpy) -> (B,) bool``, True
    where the candidate's induced subtree on ``constraint_taxa`` (default
    all leaves) holds every required split (the split or its complement
    within the taxa as a clade). Taxa outside the set get salt 0, so each
    clade hashes to the hash of its restriction; membership compares
    additive uint64 clade hashes (collision probability about B n / 2^64).
    """
    if constraint_taxa is None:
        constraint_taxa = frozenset(range(n_leaves))
    rng = np.random.default_rng(0xC0FFEE)
    salt = rng.integers(1, 2**62, size=n_leaves, dtype=np.uint64) * 2 + 1
    inside = np.zeros(n_leaves, bool)
    inside[sorted(constraint_taxa)] = True
    salt = np.where(inside, salt, np.uint64(0))
    total = salt.sum(dtype=np.uint64)
    wanted = []
    for split in required_splits:
        if not split <= constraint_taxa:
            raise ValueError("required split not within constraint_taxa")
        h = salt[sorted(split)].sum(dtype=np.uint64)
        # The complement's hash, wrapped mod 2^64 by hand (numpy warns on
        # unsigned scalar overflow).
        wanted.append((h, np.uint64((int(total) - int(h)) % (1 << 64))))
    if not wanted:
        return lambda children_batch: np.ones(np.asarray(children_batch).shape[0], bool)

    def check(children_batch: np.ndarray) -> np.ndarray:
        children_batch = np.asarray(children_batch)
        anc = _clade_hash_batch(children_batch, n_leaves, salt)[:, n_leaves:]
        ok = np.ones(children_batch.shape[0], bool)
        for h, comp in wanted:
            ok &= (anc == h).any(axis=1) | (anc == comp).any(axis=1)
        return ok

    return check


def constrained_start(
    constraint: Topology,
    constraint_leaf_ids: list[int],
    n_leaves: int,
    seed: int = 0,
    device="cuda",
) -> Topology:
    """A full-taxa starting topology that holds a (partial) constraint.

    Starts from the constraint tree (its leaf ``i`` is taxon
    ``constraint_leaf_ids[i]``) and grafts every remaining taxon, in
    ascending order, onto an edge drawn uniformly by
    ``default_rng(seed)``: a new leaf never changes the induced subtree on
    the constraint taxa, so the result satisfies the constraint.
    """
    from trex_tpu_torch.io.fallback import _canonicalize
    from trex_tpu_torch.topology import from_numpy

    rng = np.random.default_rng(seed)
    c_children, _ = constraint.to_numpy()
    k = constraint.n_leaves
    # Node ids: the global taxa for leaves, fresh ids for internals.
    node_of = {i: constraint_leaf_ids[i] for i in range(k)}
    node_of.update({k + a: n_leaves + a for a in range(k - 1)})
    next_id = n_leaves + k - 1
    kids: dict[int, list[int]] = {
        node_of[k + a]: [node_of[int(c_children[a, 0])], node_of[int(c_children[a, 1])]]
        for a in range(k - 1)
    }
    edges = [(parent, child) for parent, cs in kids.items() for child in cs]
    for taxon in sorted(set(range(n_leaves)) - set(constraint_leaf_ids)):
        parent, child = edges[rng.integers(len(edges))]
        joint = next_id
        next_id += 1
        kids[parent][kids[parent].index(child)] = joint
        kids[joint] = [child, taxon]
        edges.append((joint, child))
        edges.append((joint, taxon))
        edges[edges.index((parent, child))] = (parent, joint)
    ch, par, _ = _canonicalize(n_leaves, kids, node_of[2 * k - 2])
    return from_numpy(ch, par, resolve_device(device))


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
    random_kicks: int = 0,
    seed: int | None = None,
    tbr_budget: int = 16384,
    constraint_splits: list[frozenset[int]] | None = None,
    constraint_taxa: frozenset[int] | None = None,
    device=None,
    timings: dict | None = None,
    mesh=None,
) -> SearchResult:
    """Greedy hill climb from ``start``; stops at a local optimum.

    Args:
        start: starting topology (moved to the climb's device).
        cost_matrix: (Q, Q) ``cost[parent_state, child_state]``; the
            enumerating scorer picks its kernel from it (``ops.dispatch``).
        leaf_sequences: (n_leaves, L) states or masks, a tensor or a numpy
            array of any integer type (the kernels get int32).
        neighborhood: ``"nni"`` (2(n - 2) moves a round), ``"spr"``
            (O(n^2)), ``"tbr"`` (SPR plus re-rooted regrafts, sampled to
            ``tbr_budget`` a round with a fresh seed each round) — each
            batch scored by ``ops.dispatch.batched_scores_fastest`` with
            ``site_weights`` and ``sequences_are_masks``; the batch carries
            a broadcast ``parents`` placeholder, since scoring reads
            ``children`` only — or ``"spr-scan"`` (unit cost only).
        score_batch_fn: optional ``(topologies, cost_matrix, leaves) ->
            (B,) scores`` (lower is better) that replaces the parsimony
            scorer of the enumerating neighborhoods — the ML climb's hook.
        random_kicks: random moves added to each neighborhood, SPR and TBR
            in turn (0 = none).
        seed: seeds the numpy generator of the kicks and of each TBR
            round's sample (the JAX package's ``int(key_data(key)[-1])``;
            default 0).
        constraint_splits: splits (leaf-index frozensets) that the induced
            subtree on ``constraint_taxa`` (default all leaves) of every
            visited tree must hold; candidates that break one are dropped
            before scoring. ``start`` must hold them (``constrained_start``).
            Not with ``"spr-scan"``.
        device: where the climb runs; default the device of a tensor
            ``leaf_sequences``, else ``cuda``.
        timings: a dict that, when given, gets the enumerating rounds'
            host seconds: ``"generate"`` (candidates, kicks, constraint
            filter, transfer) and ``"score"`` (the batch calls up to their
            scores on the host).
        mesh: optional ('tree', 'site') ``parallel.mesh.Mesh``: every rank
            runs the climb with the same inputs (None: this device alone,
            the same calls on a 1 x 1 mesh). The enumerating
            neighbourhoods score each batch across the mesh
            (``parallel.sharded.mesh_score_batch``: candidates over
            ``tree``, sites over ``site``; the scores are the single-device
            ones bit for bit), unless a ``score_batch_fn`` is given;
            ``"spr-scan"`` splits each scan's prune rows over ``tree`` and
            reduces them to the best move (``sharded_spr_scan_best``).
    """
    from trex_tpu_torch.ops.dispatch import check_alphabet

    if device is None and torch.is_tensor(leaf_sequences):
        device = leaf_sequences.device
    device = resolve_device("cuda" if device is None else device)
    leaves = torch.as_tensor(leaf_sequences, device=device)
    weights = (
        None if site_weights is None
        else torch.as_tensor(site_weights, device=device).to(torch.float32)
    )
    start = start.to(device)

    check_constraint = None
    if constraint_splits:
        if neighborhood == "spr-scan":
            raise ValueError(
                "constrained search is not supported with spr-scan (use neighborhood='spr')"
            )
        check_constraint = constraint_mask(constraint_splits, start.n_leaves, constraint_taxa)
        if not check_constraint(start.to_numpy()[0][None])[0]:
            raise ValueError("the starting topology violates the constraint splits")

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
            mesh=mesh,
        )
    if neighborhood not in ("nni", "spr", "tbr"):
        raise ValueError(f"unknown neighborhood {neighborhood!r}")
    from trex_tpu_torch.io import nni_neighbors_host, spr_neighborhood_host, tbr_neighborhood_host
    from trex_tpu_torch.topology import from_numpy

    if score_batch_fn is None:
        from trex_tpu_torch.parallel.sharded import mesh_score_batch

        check_alphabet(cost_matrix, leaves, sequences_are_masks=sequences_are_masks)
        score_batch_fn = mesh_score_batch(mesh, leaves, weights, sequences_are_masks)

    def score_batch(topos: Topology):
        return score_batch_fn(topos, cost_matrix, leaves)

    def single_score(topo: Topology) -> float:
        return float(score_batch(Topology(topo.children[None], topo.parents[None]))[0])

    rng = np.random.default_rng(0 if seed is None else seed)
    if neighborhood == "tbr":
        def neighbors_fn(topo):
            # A fresh seed a round: a truncated TBR set is sampled anew.
            return tbr_neighborhood_host(
                topo, max_trees=tbr_budget, seed=int(rng.integers(0, 2**63 - 1)))
    elif neighborhood == "spr":
        neighbors_fn = spr_neighborhood_host
    else:
        neighbors_fn = nni_neighbors_host

    current = start
    current_score = single_score(current)
    trace = [current_score]
    evaluations = 1
    n_all = start.n_all
    clock = {"generate": 0.0, "score": 0.0}
    for round_idx in range(max_rounds):
        t0 = time.perf_counter()
        nbr_children, nbr_parents = neighbors_fn(current)
        if random_kicks > 0:
            nbr_children, nbr_parents = _with_kicks(
                nbr_children, nbr_parents, current.to_numpy()[0], random_kicks, rng)
        if check_constraint is not None:
            keep = check_constraint(nbr_children)
            if not keep.any():
                break
            nbr_children, nbr_parents = nbr_children[keep], nbr_parents[keep]
        n_real = int(nbr_children.shape[0])
        batch = Topology(
            children=torch.as_tensor(nbr_children, device=device),
            parents=torch.as_tensor(nbr_parents[0], device=device).expand(n_real, n_all),
        )
        t1 = time.perf_counter()
        scores = score_batch(batch).cpu().numpy()
        clock["generate"] += t1 - t0
        clock["score"] += time.perf_counter() - t1
        evaluations += n_real
        best = int(scores.argmin())
        if scores[best] >= current_score:
            break
        # Copies: the native generators return views into reused buffers.
        current = from_numpy(nbr_children[best].copy(), nbr_parents[best].copy(), device)
        current_score = float(scores[best])
        trace.append(current_score)
    else:
        round_idx = max_rounds
    if timings is not None:
        timings.update(clock)
    return SearchResult(current, current_score, round_idx, evaluations, trace)


def _with_kicks(nbr_children, nbr_parents, children, count, rng):
    """The neighborhood plus ``count`` random valid moves of ``children``,
    SPR and TBR in turn, drawn (prune, regraft, reroot) from ``rng``."""
    from trex_tpu_torch.io import spr_move_host, tbr_move_host

    n_all = 2 * children.shape[0] + 1
    extra_c, extra_p = [], []
    while len(extra_c) < count:
        prune = int(rng.integers(0, n_all - 1))
        regraft = int(rng.integers(0, n_all - 1))
        reroot = int(rng.integers(0, n_all))
        if len(extra_c) % 2 == 0:
            moved = spr_move_host(children, prune, regraft)
        else:
            moved = tbr_move_host(children, prune, reroot, regraft)
        if moved is not None:
            extra_c.append(moved[0])
            extra_p.append(moved[1])
    return (np.concatenate([nbr_children, np.stack(extra_c)]),
            np.concatenate([nbr_parents, np.stack(extra_p)]))


def _spr_scan_climb(
    start: Topology,
    leaf_sequences: torch.Tensor,
    max_rounds: int,
    *,
    site_weights: torch.Tensor | None,
    sequences_are_masks: bool,
    mesh=None,
) -> SearchResult:
    """Hill climb where each round is one analytic all-SPR scan, its prune
    rows over ``mesh``'s ``tree`` axis (None: this device alone), reduced
    to the best move by ``parallel.sharded.sharded_spr_scan_best``.

    ``evaluations`` counts scored candidates (finite scan entries) for
    comparability with the enumerating climber.
    """
    from trex_tpu_torch.io import spr_move
    from trex_tpu_torch.parallel.sharded import sharded_spr_scan_best

    def run_scan(topo):
        return sharded_spr_scan_best(mesh, topo, leaf_sequences, site_weights,
                                     sequences_are_masks=sequences_are_masks)

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


def batched_random_restarts(
    seed: int,
    n_leaves: int,
    cost_matrix: torch.Tensor,
    leaf_sequences,
    *,
    n_starts: int = 8,
    max_rounds: int = 100,
    score_batch_fn=None,
    neighborhood: str = "nni",
    device=None,
) -> SearchResult:
    """Hill climb from ``n_starts`` random topologies
    (``io.sample_topologies(seed, ...)``) and return the best. The JAX
    package's version takes a key and samples from its last word; the
    port takes that integer as ``seed``, as ``random_topologies`` does.
    ``device``: as ``parsimony_hill_climb``'s."""
    from trex_tpu_torch.io import sample_topologies

    if device is None:
        device = leaf_sequences.device if torch.is_tensor(leaf_sequences) else "cuda"
    dev = resolve_device(device)
    starts = sample_topologies(int(seed), n_leaves, n_starts, dev)
    best: SearchResult | None = None
    for s in range(n_starts):
        result = parsimony_hill_climb(
            Topology(starts.children[s], starts.parents[s]), cost_matrix, leaf_sequences,
            max_rounds=max_rounds, score_batch_fn=score_batch_fn, neighborhood=neighborhood,
            device=dev,
        )
        if best is None or result.score < best.score:
            best = result
    return best
