"""Parsimony ratchet and tree-distance utilities (counterpart of
``trex_tpu/search/ratchet.py``).

The ratchet (Nixon 1999) alternates hill climbing on reweighted data (a
random share of sites upweighted, which distorts the landscape) with
climbing on the true data, keeping the best tree seen. Every climb goes
through ``parsimony_hill_climb`` with the iteration's weights: the
analytic scan (``"spr-scan"``) or K1 on the enumerated candidates.
"""

from __future__ import annotations

import json
import os

import torch

from trex_tpu_torch.search.bootstrap import subtree_leaf_sets
from trex_tpu_torch.search.hillclimb import SearchResult, parsimony_hill_climb
from trex_tpu_torch.topology import Topology


def robinson_foulds(a: Topology, b: Topology) -> int:
    """Rooted RF distance: clades present in exactly one tree."""
    return len(set(subtree_leaf_sets(a)) ^ set(subtree_leaf_sets(b)))


def unrooted_splits(topology: Topology) -> set[frozenset[int]]:
    """Nontrivial bipartitions, root placement ignored: each clade taken
    as the side of its split without leaf 0; single leaves and
    all-but-one dropped."""
    n_leaves = topology.n_leaves
    all_leaves = frozenset(range(n_leaves))
    out = set()
    for clade in subtree_leaf_sets(topology):
        side = all_leaves - clade if 0 in clade else clade
        if 1 < len(side) < n_leaves - 1:
            out.add(side)
    return out


def rf_distance_unrooted(a: Topology, b: Topology) -> int:
    """Robinson-Foulds distance on unrooted splits (root-invariant)."""
    return len(unrooted_splits(a) ^ unrooted_splits(b))


def perturbations(
    generator: torch.Generator, n_iterations: int, length: int, perturb_fraction: float = 0.25
) -> torch.Tensor:
    """(n_iterations, L) bool: each iteration's upweighted sites, Bernoulli
    ``perturb_fraction`` draws from ``generator`` (on its device)."""
    draws = torch.rand((n_iterations, length), generator=generator,
                       device=generator.device)
    return draws < perturb_fraction


def parsimony_ratchet(
    start: Topology,
    cost_matrix: torch.Tensor,
    leaf_sequences,
    *,
    upweighted=None,
    generator: torch.Generator | None = None,
    n_iterations: int = 10,
    perturb_fraction: float = 0.25,
    perturb_weight: float = 3.0,
    climb_rounds: int = 30,
    neighborhood: str = "spr",
    progress_dir: str | None = None,
    site_weights=None,
    sequences_are_masks: bool = False,
    device=None,
    mesh=None,
) -> SearchResult:
    """Run the parsimony ratchet from ``start``.

    Each iteration upweights its sites by ``perturb_weight`` and climbs
    under that objective, climbs again under the true one from where it
    landed, and keeps the best true-score tree. The upweighted sites come
    from ``upweighted``, an (n_iterations, L) bool array (the JAX
    package's Bernoulli draws replayed), or else from ``generator``
    (``perturbations``); one of the two is required when
    ``n_iterations > 0``.

    ``site_weights``: base per-site multiplicities (compressed patterns),
    which the perturbation multiplies. ``progress_dir``: after every
    iteration the best tree so far is written to ``best.nwk`` and a line
    (iteration, best score, evaluations) appended to ``trace.jsonl``.
    ``device``: where the climbs run (default: a tensor
    ``leaf_sequences``'s device, else ``cuda``). ``mesh``: every climb,
    perturbed and true, scores across the ('tree', 'site') mesh
    (``parsimony_hill_climb``'s ``mesh``).

    Returns the best ``SearchResult``; its trace is the best true score
    after each iteration.
    """
    from trex_tpu_torch._device import resolve_device

    if device is None and torch.is_tensor(leaf_sequences):
        device = leaf_sequences.device
    device = resolve_device("cuda" if device is None else device)
    leaves = torch.as_tensor(leaf_sequences, device=device)
    length = leaves.shape[-1]
    base_weights = (
        torch.ones((length,), dtype=torch.float32, device=device)
        if site_weights is None
        else torch.as_tensor(site_weights, device=device).to(torch.float32)
    )
    if n_iterations > 0 and upweighted is None:
        if generator is None:
            raise ValueError("the ratchet needs its upweighted sites or a generator")
        upweighted = perturbations(generator, n_iterations, length, perturb_fraction)
    if upweighted is not None:
        upweighted = torch.as_tensor(upweighted, device=device).to(torch.bool)

    def climb(topo: Topology, weights: torch.Tensor) -> SearchResult:
        return parsimony_hill_climb(
            topo, cost_matrix, leaves,
            max_rounds=climb_rounds, neighborhood=neighborhood,
            site_weights=weights, sequences_are_masks=sequences_are_masks, mesh=mesh,
        )

    def dump_progress(iteration: int) -> None:
        if progress_dir is None:
            return
        from trex_tpu_torch.io import save_newick

        os.makedirs(progress_dir, exist_ok=True)
        with open(os.path.join(progress_dir, "best.nwk"), "w") as fh:
            fh.write(save_newick(best_topo) + "\n")
        with open(os.path.join(progress_dir, "trace.jsonl"), "a") as fh:
            fh.write(json.dumps({"iteration": iteration, "best_score": best_score,
                                 "evaluations": evaluations}) + "\n")

    result = climb(start, base_weights)
    current = result.topology
    best_topo, best_score = result.topology, result.score
    trace = [best_score]
    evaluations = result.evaluations
    dump_progress(0)
    for i in range(n_iterations):
        weights = base_weights * torch.where(upweighted[i], perturb_weight, 1.0)
        perturbed = climb(current, weights)
        evaluations += perturbed.evaluations
        reclimbed = climb(perturbed.topology, base_weights)
        evaluations += reclimbed.evaluations
        current = reclimbed.topology
        if reclimbed.score < best_score:
            best_topo, best_score = reclimbed.topology, reclimbed.score
        trace.append(best_score)
        dump_progress(i + 1)
    return SearchResult(best_topo, best_score, n_iterations, evaluations, trace)
