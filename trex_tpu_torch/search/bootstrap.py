"""Bootstrap analysis: site-resampled scoring and split support under
parsimony and likelihood (counterpart of ``trex_tpu/search/bootstrap.py``).

A replicate resamples alignment sites with replacement. Every score here
is a weighted site sum, so a replicate is an integer site-weight vector:
the replicates' trees are scored under their weights (K1 on the card for
parsimony, K4's per-branch mode for likelihood), with no copy of the
data. Split support is the share of replicate optima that hold each
bipartition of a reference tree.
"""

from __future__ import annotations

import numpy as np
import torch

from trex_tpu_torch.topology import Topology


def bootstrap_site_weights(
    length: int, n_replicates: int, generator: torch.Generator
) -> torch.Tensor:
    """(R, L) int32 site counts, each row a multinomial draw of L sites
    with probability 1/L each (so it sums to L), from ``generator`` (on
    its device)."""
    picks = torch.randint(0, length, (n_replicates, length), generator=generator,
                          device=generator.device)
    counts = torch.zeros((n_replicates, length), dtype=torch.int32, device=picks.device)
    return counts.scatter_add_(1, picks, torch.ones_like(picks, dtype=torch.int32))


def bootstrap_scores(
    topology: Topology,
    cost_matrix: torch.Tensor,
    leaf_sequences: torch.Tensor,
    weights: torch.Tensor,
    use_fitch: bool = True,
) -> torch.Tensor:
    """(R,) parsimony scores of one topology under R site-weight vectors:
    unit-cost Fitch (K1 on the card), or with ``use_fitch=False`` the
    Sankoff DP under ``cost_matrix``."""
    from trex_tpu_torch.ops.fitch import fitch_score
    from trex_tpu_torch.ops.sankoff import sankoff_score

    weights = torch.as_tensor(weights, device=leaf_sequences.device).to(torch.float32)
    if use_fitch:
        return torch.stack([fitch_score(topology, leaf_sequences, w) for w in weights])
    return torch.stack([
        sankoff_score(topology, cost_matrix, leaf_sequences, site_mask=w) for w in weights
    ])


def bootstrap_log_likelihoods(
    topology: Topology,
    branch_lengths,
    leaf_sequences,
    n_states: int,
    weights,
) -> torch.Tensor:
    """(R,) JC69 log-likelihoods of one tree under R site-weight vectors
    (R, L): the per-site log-likelihoods once, then one product with the
    weights (the log-likelihood is a weighted site sum)."""
    from trex_tpu_torch.ops.likelihood import _f32, per_site_log_likelihood

    per_site = per_site_log_likelihood(topology, branch_lengths, leaf_sequences, n_states)
    return _f32(weights, device=per_site.device) @ per_site


def subtree_leaf_sets(topology: Topology) -> list[frozenset[int]]:
    """Leaf set (clade) below each ancestor, host-side."""
    children, _ = topology.to_numpy()
    n_leaves = topology.n_leaves
    sets: dict[int, frozenset[int]] = {i: frozenset([i]) for i in range(n_leaves)}
    for a in range(n_leaves - 1):
        sets[n_leaves + a] = sets[int(children[a, 0])] | sets[int(children[a, 1])]
    return [sets[n_leaves + a] for a in range(n_leaves - 1)]


def subtree_leaf_masks(children: np.ndarray) -> list[int]:
    """Leaf set below each ancestor of one host (n_anc, 2) children array,
    as a Python int bitmask (bit i: leaf i); the clades of
    ``subtree_leaf_sets`` in a form whose unions and complements are cheap
    at hundreds of taxa."""
    n_leaves = children.shape[0] + 1
    masks = [1 << i for i in range(n_leaves)]
    for c1, c2 in children.tolist():
        masks.append(masks[c1] | masks[c2])
    return masks[n_leaves:]


def split_support(reference: Topology, replicate_best: list[Topology]) -> np.ndarray:
    """(n_ancestors,) share of the replicate trees holding each ancestor's
    clade of ``reference``, indexed like ``reference.children`` (the root's
    is 1)."""
    ref_splits = subtree_leaf_sets(reference)
    counts = np.zeros(len(ref_splits))
    for topo in replicate_best:
        rep = set(subtree_leaf_sets(topo))
        for i, split in enumerate(ref_splits):
            if split in rep:
                counts[i] += 1
    return counts / max(len(replicate_best), 1)


def _replicate_weights(
    length: int, n_replicates: int, site_weights, generator: torch.Generator
) -> torch.Tensor:
    """(R, L) bootstrap site counts. With base weights (compressed
    patterns), pattern occurrences are resampled: each row draws the total
    count from a multinomial proportional to the base weights."""
    if site_weights is None:
        return bootstrap_site_weights(length, n_replicates, generator)
    base = torch.as_tensor(site_weights, device=generator.device).to(torch.float64)
    total = int(base.sum())
    picks = torch.multinomial(base.expand(n_replicates, length), total, replacement=True,
                              generator=generator)
    counts = torch.zeros((n_replicates, length), dtype=torch.int32, device=picks.device)
    return counts.scatter_add_(1, picks, torch.ones_like(picks, dtype=torch.int32))


def bootstrap_analysis(
    reference: Topology,
    cost_matrix: torch.Tensor,
    leaf_sequences,
    n_replicates: int = 100,
    search_rounds: int = 20,
    neighborhood: str = "nni",
    site_weights=None,
    sequences_are_masks: bool = False,
    *,
    replicate_weights=None,
    generator: torch.Generator | None = None,
    device=None,
    mesh=None,
) -> tuple[np.ndarray, list[Topology]]:
    """Bootstrap split support for ``reference``.

    Each replicate climbs from ``reference`` (``parsimony_hill_climb``,
    ``search_rounds`` rounds of ``neighborhood``) under its site weights;
    a split's support is the share of replicate optima that keep it. The
    weights come from ``replicate_weights``, (R, L) counts (the JAX
    package's draws replayed), or else ``_replicate_weights`` from
    ``generator`` (pattern occurrences resampled when ``site_weights``,
    the base pattern counts, is given). ``mesh``: each replicate's climb
    scores its batches across the ('tree', 'site') mesh under the
    replicate's weights (``parsimony_hill_climb``'s ``mesh``).

    Returns (support (n_ancestors,), the replicates' best topologies).
    """
    from trex_tpu_torch._device import resolve_device
    from trex_tpu_torch.search.hillclimb import parsimony_hill_climb

    if device is None and torch.is_tensor(leaf_sequences):
        device = leaf_sequences.device
    device = resolve_device("cuda" if device is None else device)
    leaves = torch.as_tensor(leaf_sequences, device=device)
    if replicate_weights is None:
        if generator is None:
            raise ValueError("bootstrap_analysis needs replicate_weights or a generator")
        replicate_weights = _replicate_weights(leaves.shape[-1], n_replicates,
                                               site_weights, generator)
    replicate_weights = torch.as_tensor(replicate_weights, device=device).to(torch.float32)
    best = [
        parsimony_hill_climb(
            reference, cost_matrix, leaves,
            max_rounds=search_rounds, neighborhood=neighborhood,
            site_weights=w, sequences_are_masks=sequences_are_masks, mesh=mesh,
        ).topology
        for w in replicate_weights[:n_replicates]
    ]
    return split_support(reference, best), best


def ml_bootstrap_analysis(
    reference: Topology,
    leaf_sequences,
    n_states: int,
    n_replicates: int = 100,
    search_rounds: int = 10,
    neighborhood: str = "nni",
    ranking_branch_length: float = 0.1,
    site_weights=None,
    sequences_are_masks: bool = False,
    *,
    replicate_weights=None,
    generator: torch.Generator | None = None,
    device=None,
    mesh=None,
) -> tuple[np.ndarray, list[Topology]]:
    """Bootstrap split support under the likelihood criterion.

    Each replicate climbs from ``reference`` (``parsimony_hill_climb``,
    ``search_rounds`` rounds of ``neighborhood``) with its candidates
    ranked by JC69 log-likelihood under the replicate's weights, every
    branch at ``ranking_branch_length``: a batch is one call of
    ``parallel.sharded.mesh_log_likelihoods`` across the ('tree', 'site')
    ``mesh`` (None: this device alone), the candidates over ``tree``, the
    sites over ``site``, on each rank's tile one call of
    ``ops.likelihood_cuda.batched_log_likelihood_cuda`` with a (B, n_all,
    Q, Q) matrix a branch and tree (K4's per-branch mode on the card, as
    the JAX package's TPU route runs its slots kernel). The weights come
    from ``replicate_weights`` ((R, L) counts, the JAX package's draws
    replayed) or else ``_replicate_weights`` from ``generator`` (pattern
    occurrences resampled when ``site_weights`` is given). ``device``:
    default the device of a tensor ``leaf_sequences``, else ``cuda``.

    Returns (support (n_ancestors,), the replicates' best topologies).
    """
    from trex_tpu_torch._device import resolve_device
    from trex_tpu_torch.parallel.sharded import mesh_log_likelihoods
    from trex_tpu_torch.search.hillclimb import parsimony_hill_climb

    if device is None and torch.is_tensor(leaf_sequences):
        device = leaf_sequences.device
    device = resolve_device("cuda" if device is None else device)
    leaves = torch.as_tensor(leaf_sequences, device=device).to(torch.int32).contiguous()
    if replicate_weights is None:
        if generator is None:
            raise ValueError("ml_bootstrap_analysis needs replicate_weights or a generator")
        replicate_weights = _replicate_weights(leaves.shape[-1], n_replicates,
                                               site_weights, generator)
    replicate_weights = torch.as_tensor(replicate_weights, device=device).to(torch.float32)
    dummy_cost = torch.zeros((n_states, n_states), device=device)
    best: list[Topology] = []
    for w in replicate_weights[:n_replicates]:
        lnl = mesh_log_likelihoods(mesh, leaves, n_states, w.contiguous(),
                                   sequences_are_masks)

        def score_batch(topos, _cost, _leaves, lnl=lnl):
            # Every branch of every candidate at the ranking length: the
            # table is one broadcast of one matrix.
            return -lnl(topos.children, float(ranking_branch_length))

        best.append(parsimony_hill_climb(
            reference, dummy_cost, leaves, max_rounds=search_rounds,
            score_batch_fn=score_batch, neighborhood=neighborhood, device=device,
        ).topology)
    return split_support(reference, best), best
