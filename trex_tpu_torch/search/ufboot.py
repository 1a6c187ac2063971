"""Ultrafast bootstrap approximation: RELL over a candidate tree set
(counterpart of ``trex_tpu/search/ufboot.py``).

No replicate re-searches: a candidate set of plausible topologies around
the ML tree (the reference, its NNI neighbourhood and a seeded TBR sample)
gets its per-site log-likelihood rows once, each candidate at its own
Newton-fitted branch lengths (``ops.likelihood_asr.per_site_matrix``: the
batched fit, then K4's per-site mode), and every (replicate, candidate)
pair is scored by RELL in one (replicates x patterns) @ (patterns x
candidates) float32 product. Each replicate's winner votes for the splits
it contains; a branch's support is the share of replicates whose winner
keeps its split.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from trex_tpu_torch.ops.likelihood import _f32
from trex_tpu_torch.search import bootstrap as _bootstrap
from trex_tpu_torch.search.alrt import rell_totals
from trex_tpu_torch.search.bootstrap import subtree_leaf_masks
from trex_tpu_torch.topology import Topology, from_numpy


@dataclass
class UFBootResult:
    """Split supports for the reference tree from RELL replicate winners.

    ``support`` is indexed like ``topology.children`` (per ancestor); the
    root's entry and other trivial splits are 1.0 by convention.
    """

    support: np.ndarray         # (n_ancestors,) in [0, 1]
    n_candidates: int           # deduplicated candidate count
    winner_counts: np.ndarray   # (n_candidates,) replicates won
    log_likelihoods: np.ndarray  # (n_candidates,) observed lnL per candidate
    reference_index: int        # row of the reference tree in the candidates


def _unrooted_split_masks(children: np.ndarray) -> set[int]:
    """The nontrivial unrooted splits of one host children array, each the
    side without leaf 0 as an int bitmask (bit i: leaf i): cheap to build
    and compare at hundreds of taxa."""
    n_leaves = children.shape[0] + 1
    full = (1 << n_leaves) - 1
    out = set()
    for clade in subtree_leaf_masks(children):
        side = full ^ clade if clade & 1 else clade
        if 1 < side.bit_count() < n_leaves - 1:
            out.add(side)
    return out


def default_candidates(topology: Topology, *, extra_tbr: int = 64, seed: int = 0) -> Topology:
    """Reference + full NNI neighbourhood + a seeded sample of ``extra_tbr``
    TBR trees, deduplicated by unrooted topology (rooted enumeration emits
    re-rootings of one unrooted tree, likelihood-identical under reversible
    models, which would split a replicate's vote), on the host (CPU)."""
    from trex_tpu_torch.io import nni_neighbors_host, tbr_neighborhood_host

    ref_children, ref_parents = topology.to_numpy()
    children = [ref_children[None]]
    parents = [ref_parents[None]]
    nc, npar = nni_neighbors_host(topology)
    if nc.shape[0]:
        children.append(nc.copy())
        parents.append(npar.copy())
    if extra_tbr > 0:
        tc, tp = tbr_neighborhood_host(topology, max_trees=extra_tbr, seed=seed)
        if tc.shape[0]:
            children.append(tc.copy())
            parents.append(tp.copy())
    all_children = np.concatenate(children)
    all_parents = np.concatenate(parents)
    seen: set[frozenset] = set()
    keep = []
    for i in range(all_children.shape[0]):
        sig = frozenset(_unrooted_split_masks(all_children[i]))
        if sig not in seen:
            seen.add(sig)
            keep.append(i)
    return from_numpy(all_children[keep], all_parents[keep])


def ultrafast_bootstrap(
    topology: Topology,
    leaf_sequences,
    n_states: int,
    *,
    candidates: Topology | None = None,
    rates=None,
    freqs=None,
    site_weights=None,
    n_replicates: int = 1000,
    n_sweeps: int = 8,
    extra_tbr: int = 64,
    seed: int = 0,
    sequences_are_masks: bool = False,
    replicate_weights=None,
    generator: torch.Generator | None = None,
    timings: dict | None = None,
    mesh=None,
) -> UFBootResult:
    """RELL ultrafast bootstrap supports for ``topology``'s internal branches.

    ``candidates``: a batched Topology (the reference is put first if
    absent); default ``default_candidates(topology, extra_tbr=, seed=)``
    (the JAX CLI's TBR seed is ``--seed + 11``, its key's last word).
    ``leaf_sequences`` lie on the device the fit runs on; ``site_weights``
    (pattern counts) are exact, and the replicates draw from them
    (``replicate_weights``, (R, P) counts, or
    ``search.bootstrap._replicate_weights`` from ``generator``).
    ``timings`` gains the seconds of the candidates ("candidates"), their
    fit ("fit"; ``per_site_matrix``'s keys under "per_site"), the RELL
    product and vote ("rell") and the split bookkeeping ("splits").
    ``mesh``: an optional ('tree', 'site') ``parallel.mesh.Mesh``
    (every rank calls with the same inputs; None: this device alone): the
    fit's candidates split over ``tree``
    (``parallel.sharded.sharded_per_site_matrix``).

    Returns ``UFBootResult``; ``support[i]`` is the share of replicates
    whose winning candidate contains the unrooted split below ancestor i.
    """
    import time

    from trex_tpu_torch.parallel.sharded import sharded_per_site_matrix

    leaves = torch.as_tensor(leaf_sequences)
    device = leaves.device
    length = leaves.shape[-1]
    weights = (torch.ones((length,), dtype=torch.float32, device=device) if site_weights is None
               else _f32(site_weights, device=device))
    clock = time.perf_counter()
    if candidates is None:
        candidates = default_candidates(topology, extra_tbr=extra_tbr, seed=seed)
    cand_children, cand_parents = candidates.to_numpy()
    ref_children, ref_parents = topology.to_numpy()
    ref_key = ref_children.tobytes()
    ref_idx = next((i for i in range(cand_children.shape[0])
                    if cand_children[i].tobytes() == ref_key), None)
    if ref_idx is None:
        cand_children = np.concatenate([ref_children[None], cand_children])
        cand_parents = np.concatenate([ref_parents[None], cand_parents])
        ref_idx = 0
    n_cand = cand_children.shape[0]
    now = time.perf_counter()
    if timings is not None:
        timings["candidates"] = now - clock
    clock = now
    fit_timings: dict = {}
    per_site = sharded_per_site_matrix(
        mesh, from_numpy(cand_children, cand_parents, device), leaves, n_states, rates=rates,
        freqs=freqs, weights=weights, n_sweeps=n_sweeps,
        sequences_are_masks=sequences_are_masks, timings=fit_timings)
    obs_ll = rell_totals(weights[None], per_site)[0].cpu().numpy().astype(np.float64)
    now = time.perf_counter()
    if timings is not None:
        timings.update(fit=now - clock, per_site=fit_timings)
    clock = now

    if replicate_weights is None:
        if generator is None:
            raise ValueError("ultrafast_bootstrap needs replicate_weights or a generator")
        replicate_weights = _bootstrap._replicate_weights(length, n_replicates, weights,
                                                          generator)
    rep_w = torch.as_tensor(replicate_weights).to(device=device, dtype=torch.float32)
    winners = rell_totals(rep_w, per_site).argmax(dim=1).cpu().numpy()  # (R,)
    winner_counts = np.bincount(winners, minlength=n_cand)
    now = time.perf_counter()
    if timings is not None:
        timings["rell"] = now - clock
    clock = now

    # Split membership: does candidate m contain reference split i?
    n_leaves = topology.n_leaves
    full = (1 << n_leaves) - 1
    ref_splits = []  # aligned with ancestors (children rows)
    for clade in subtree_leaf_masks(ref_children):
        side = full ^ clade if clade & 1 else clade
        ref_splits.append(side if 1 < side.bit_count() < n_leaves - 1 else None)
    contains = np.ones((n_cand, topology.n_ancestors), dtype=np.float64)
    for m in range(n_cand):
        if not winner_counts[m]:
            continue  # a row that no replicate won adds nothing
        cand_splits = _unrooted_split_masks(cand_children[m])
        for i, split in enumerate(ref_splits):
            if split is not None:
                contains[m, i] = 1.0 if split in cand_splits else 0.0
    support = (winner_counts[:, None] * contains).sum(axis=0) / max(int(winners.shape[0]), 1)
    if timings is not None:
        timings["splits"] = time.perf_counter() - clock
    return UFBootResult(
        support=support,
        n_candidates=n_cand,
        winner_counts=winner_counts,
        log_likelihoods=obs_ll,
        reference_index=int(ref_idx),
    )
