"""Approximate likelihood-ratio branch supports: aLRT, SH-aLRT and RELL
(counterpart of ``trex_tpu/search/alrt.py``).

For every internal branch the inferred resolution is compared with the
nearest-neighbour-interchange alternatives around it (the other
resolutions of the induced quartet), each at its own Newton-fitted branch
lengths, from per-site log-likelihood rows:

- ``alrt``: 2 (lnL_best - lnL_second) per branch, negative when an
  alternative wins;
- ``sh_alrt``: the SH-like support of Guindon et al. 2010, the observed
  statistic against RELL replicates of it from per-site rows centred at
  their observed totals;
- ``rell``: the share of RELL resamples the inferred resolution wins.

Every alternative's rows come from one ``ops.likelihood_asr.
per_site_matrix`` call (the batched Newton fit, then K4's per-site mode),
the replicates' totals from one float32 product; the statistics are host
numpy, as in the reference.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from trex_tpu_torch.ops.likelihood import _f32, highest_matmul_precision
from trex_tpu_torch.search import bootstrap as _bootstrap
from trex_tpu_torch.search.bootstrap import subtree_leaf_masks
from trex_tpu_torch.topology import Topology, from_numpy


@dataclass
class BranchSupports:
    """Per-ancestor support values, indexed like ``topology.children``.

    Untested branches (the root, and ancestors whose quartet has no NNI
    alternative) are NaN in ``alrt`` and 1.0 in the support fields.
    """

    alrt: np.ndarray        # 2*(lnL_best - lnL_second), NaN where untested
    sh_alrt: np.ndarray     # SH-like support in [0, 1]
    rell: np.ndarray        # plain RELL win fraction in [0, 1]
    log_likelihood: float   # reference tree lnL at its Newton lengths


def _bipartition_masks(children: np.ndarray) -> list[int | None]:
    """The canonical unrooted bipartition of each ancestor's clade in one
    host children array: the side not containing leaf 0, as an int bitmask
    (bit i: leaf i); None for a trivial split (a side of size < 2)."""
    n_leaves = children.shape[0] + 1
    full = (1 << n_leaves) - 1
    out: list[int | None] = []
    for clade in subtree_leaf_masks(children):
        comp = full ^ clade
        if clade.bit_count() < 2 or comp.bit_count() < 2:
            out.append(None)
        else:
            out.append(comp if clade & 1 else clade)
    return out


def _root_edge_alternatives(topology: Topology) -> tuple[list[np.ndarray], list[np.ndarray]]:
    """The two quartet resolutions of the unrooted edge between the root's
    children (rooted NNI only re-roots around it), each canonicalized;
    empty when a root child is a leaf."""
    from trex_tpu_torch.io.fallback import _canonicalize

    children, _ = topology.to_numpy()
    n_leaves = topology.n_leaves
    root = topology.n_all - 1
    a, b = (int(c) for c in children[root - n_leaves])
    if a < n_leaves or b < n_leaves:
        return [], []
    kids = {n_leaves + i: [int(children[i, 0]), int(children[i, 1])] for i in range(n_leaves - 1)}
    x, y = kids[a]
    u, v = kids[b]
    out_children: list[np.ndarray] = []
    out_parents: list[np.ndarray] = []
    for new_a, new_b in (([x, u], [y, v]), ([x, v], [u, y])):
        k2 = dict(kids)
        k2[a] = new_a
        k2[b] = new_b
        ch, par, _ = _canonicalize(n_leaves, k2, root)
        out_children.append(ch)
        out_parents.append(par)
    return out_children, out_parents


def _nni_alternatives_by_edge(topology: Topology) -> tuple[np.ndarray, np.ndarray, list[list[int]]]:
    """All NNI neighbours (plus the root edge's two alternatives) as host
    (children, parents), and per ancestor the rows whose move destroyed
    that ancestor's unrooted bipartition. Re-rootings of the same unrooted
    tree are skipped and alternatives resolving to the same unrooted
    topology counted once per edge; the root's two children share one
    unrooted edge and get identical entries."""
    from trex_tpu_torch.io import nni_neighbors_host

    n_leaves = topology.n_leaves
    children, parents = nni_neighbors_host(topology)
    children, parents = children.copy(), parents.copy()
    root_alt_children, root_alt_parents = _root_edge_alternatives(topology)
    if root_alt_children:
        children = np.concatenate([children, np.stack(root_alt_children)])
        parents = np.concatenate([parents, np.stack(root_alt_parents)])
    # Bipartitions as int bitmasks: cheap to build for every neighbour at
    # hundreds of taxa.
    ref_biparts = _bipartition_masks(topology.to_numpy()[0])
    ref_set = {b for b in ref_biparts if b is not None}
    edges_of: dict[int, list[int]] = {}
    for i, bipart in enumerate(ref_biparts):
        if bipart is not None:
            edges_of.setdefault(bipart, []).append(i)
    n_anc = topology.n_ancestors
    by_edge: list[list[int]] = [[] for _ in range(n_anc)]
    seen_per_edge: list[set[frozenset]] = [set() for _ in range(n_anc)]
    for m in range(children.shape[0]):
        neigh_set = {b for b in _bipartition_masks(children[m]) if b is not None}
        if neigh_set == ref_set:
            continue  # re-rooting of the same unrooted tree
        signature = frozenset(neigh_set)
        for bipart in ref_set - neigh_set:
            for i in edges_of[bipart]:
                if signature not in seen_per_edge[i]:
                    seen_per_edge[i].add(signature)
                    by_edge[i].append(m)
    return children, parents, by_edge


@highest_matmul_precision
def rell_totals(replicate_weights: torch.Tensor, per_site: torch.Tensor) -> torch.Tensor:
    """(R, M) RELL totals: the (R, P) replicate counts times the (M, P)
    per-site rows, one float32 product with TF32 off."""
    return torch.matmul(replicate_weights, per_site.T)


def branch_supports(
    topology: Topology,
    leaf_sequences,
    n_states: int,
    *,
    rates=None,
    freqs=None,
    site_weights=None,
    n_replicates: int = 1000,
    n_sweeps: int = 8,
    sequences_are_masks: bool = False,
    replicate_weights=None,
    generator: torch.Generator | None = None,
    timings: dict | None = None,
    mesh=None,
) -> BranchSupports:
    """aLRT / SH-aLRT / RELL supports for every internal branch.

    ``leaf_sequences`` (n_leaves, P) states or masks on the device the work
    runs on; compressed patterns with ``site_weights`` are exact. The
    replicates are ``replicate_weights`` ((R, P) counts, e.g. the JAX
    package's draws) or ``search.bootstrap._replicate_weights`` from
    ``generator``. ``timings`` gains the seconds of the alternatives'
    enumeration ("enumerate"), their fit ("fit"; ``per_site_matrix``'s
    keys under "per_site") and the replicates' statistics ("rell").
    ``mesh``: an optional ('tree', 'site') ``parallel.mesh.Mesh``
    (every rank calls with the same inputs; None: this device alone): the
    fit's candidates split over ``tree``
    (``parallel.sharded.sharded_per_site_matrix``).
    """
    import time

    from trex_tpu_torch.parallel.sharded import sharded_per_site_matrix

    leaves = torch.as_tensor(leaf_sequences)
    device = leaves.device
    length = leaves.shape[-1]
    weights = (torch.ones((length,), dtype=torch.float32, device=device) if site_weights is None
               else _f32(site_weights, device=device))
    clock = time.perf_counter()
    children, parents, by_edge = _nni_alternatives_by_edge(topology)
    # Score only the rows some edge tests (re-rootings and duplicates were
    # dropped from by_edge); the reference goes first in the same batch.
    used = sorted({m for rows in by_edge for m in rows})
    remap = {m: i for i, m in enumerate(used)}
    by_edge = [[remap[m] for m in rows] for rows in by_edge]
    ref_children, ref_parents = topology.to_numpy()
    batch = from_numpy(np.concatenate([ref_children[None], children[used]]),
                       np.concatenate([ref_parents[None], parents[used]]), device)
    now = time.perf_counter()
    if timings is not None:
        timings["enumerate"] = now - clock
    clock = now
    n_anc = topology.n_ancestors
    alrt = np.full((n_anc,), np.nan)
    sh = np.ones((n_anc,))
    rell = np.ones((n_anc,))
    fit_timings: dict = {}
    per_site = sharded_per_site_matrix(
        mesh, batch, leaves, n_states, rates=rates, freqs=freqs, weights=weights,
        n_sweeps=n_sweeps, sequences_are_masks=sequences_are_masks, timings=fit_timings)
    observed = rell_totals(weights[None], per_site)[0].cpu().numpy().astype(np.float64)
    ref_ll = float(observed[0])
    if timings is not None:
        timings.update(fit=time.perf_counter() - clock, per_site=fit_timings)
    if not used:
        return BranchSupports(alrt, sh, rell, ref_ll)
    clock = time.perf_counter()
    if replicate_weights is None:
        if generator is None:
            raise ValueError("branch_supports needs replicate_weights or a generator")
        # Drawn from the base counts (ones without site weights), as the
        # reference draws them.
        replicate_weights = _bootstrap._replicate_weights(length, n_replicates, weights,
                                                          generator)
    rep_w = torch.as_tensor(replicate_weights).to(device=device, dtype=torch.float32)
    totals = rell_totals(rep_w, per_site).cpu().numpy().astype(np.float64)  # (R, 1 + M)
    ref_rep_np, neigh_rep_np = totals[:, 0], totals[:, 1:]
    neigh_obs_np = observed[1:]

    for i, rows in enumerate(by_edge):
        if not rows:
            continue  # untested branch (no NNI perturbs this split)
        obs = np.concatenate([[ref_ll], neigh_obs_np[rows]])
        order = np.argsort(obs)[::-1]
        delta_obs = 2.0 * (obs[order[0]] - obs[order[1]])
        alrt[i] = delta_obs if order[0] == 0 else -delta_obs
        reps = np.concatenate([ref_rep_np[:, None], neigh_rep_np[:, rows]], axis=1)
        rell[i] = float(np.mean(reps.argmax(axis=1) == 0))
        if order[0] != 0:
            sh[i] = 0.0  # an alternative beats the inferred resolution
            continue
        # SH-like: centre each configuration at its observed value and hold
        # the observed statistic against the replicates' null statistic.
        centered = reps - obs[None, :]
        part = np.partition(centered, centered.shape[1] - 2, axis=1)
        delta_null = 2.0 * (part[:, -1] - part[:, -2])
        sh[i] = float(np.mean(delta_obs > delta_null))
    if timings is not None:
        timings["rell"] = time.perf_counter() - clock
    return BranchSupports(alrt, sh, rell, ref_ll)
