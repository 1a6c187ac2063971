"""Strict molecular clock: node ages, the ML clock fit and the clock
likelihood-ratio test (counterpart of ``trex_tpu/ops/clock.py``).

Ages are indexed by node (leaves first, root last); the edge above node v
has length age(parent(v)) - age(v). The ML fit parameterises each
ancestor's age as its higher child's age plus softplus(theta), so no step
can make a branch negative. Plain PyTorch: the fit prunes a level at a
time (``ops.likelihood.Levels``) under Adam, as ``optimize_branch_lengths``.
"""

from __future__ import annotations

import torch

from trex_tpu_torch.topology import Topology


def ages_to_lengths(topology: Topology, ages: torch.Tensor) -> torch.Tensor:
    """(..., n_all) edge lengths above each node from node ages (the
    root's 0)."""
    parents = topology.parents.to(device=ages.device, dtype=torch.int64)
    lengths = ages.index_select(-1, parents) - ages
    return torch.cat([lengths[..., :-1], torch.zeros_like(lengths[..., -1:])], dim=-1)


def _height_schedule(topology: Topology, device) -> list[tuple]:
    """The ancestors grouped by height: (offsets, first children, second
    children) a height, lowest first (host schedule, read once)."""
    pairs = topology.children.cpu().tolist()
    n_leaves = len(pairs) + 1
    height = [0] * (n_leaves + len(pairs))
    groups: dict[int, list[int]] = {}
    for a, (c1, c2) in enumerate(pairs):
        height[n_leaves + a] = h = 1 + max(height[c1], height[c2])
        groups.setdefault(h, []).append(a)
    return [tuple(torch.tensor(x, dtype=torch.int64, device=device) for x in
                  (offs, [pairs[a][0] for a in offs], [pairs[a][1] for a in offs]))
            for _, offs in sorted(groups.items())]


def increments_to_ages(topology: Topology, increments: torch.Tensor,
                       schedule: list[tuple] | None = None) -> torch.Tensor:
    """(..., n_anc) positive increments -> (..., n_all) ages (leaves at 0):
    an ancestor's age is its higher child's plus its increment. One step a
    height of the tree (``schedule``, else built from the topology), out of
    place, so autograd differentiates it."""
    n_leaves = topology.n_leaves
    if schedule is None:
        schedule = _height_schedule(topology, increments.device)
    ages = increments.new_zeros(increments.shape[:-1] + (topology.n_all,))
    for offs, c1, c2 in schedule:
        age = torch.maximum(ages.index_select(-1, c1), ages.index_select(-1, c2))
        ages = ages.index_copy(-1, n_leaves + offs, age + increments.index_select(-1, offs))
    return ages


def optimize_clock(
    topology: Topology,
    leaf_sequences,
    n_states: int,
    *,
    init_increment: float = 0.05,
    learning_rate: float = 0.05,
    n_iterations: int = 500,
    sequences_are_masks: bool = False,
    site_weights=None,
    rates=None,
    freqs=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """ML node ages under a strict clock: Adam (no clipping) on the n - 1
    softplus age increments. Returns (ages (n_all,), the loss before each
    step (n_iterations,))."""
    from trex_tpu_torch.ops.likelihood import (
        Levels,
        _category_log_likelihoods,
        _masked_sum,
        _softplus_inverse,
    )
    from trex_tpu_torch.search.optimizers import make_optimizer

    leaves = torch.as_tensor(leaf_sequences)
    device = leaves.device
    topology = topology.to(device)
    levels = Levels(topology.children, device)
    schedule = _height_schedule(topology, device)
    theta = torch.full((topology.n_ancestors,), float(_softplus_inverse(init_increment)),
                       device=device).requires_grad_(True)
    optimizer = make_optimizer("adam", learning_rate, [theta], clip_global_norm=None)
    losses = torch.empty((n_iterations,), dtype=torch.float32, device=device)
    for step in range(n_iterations):
        optimizer.zero_grad()
        ages = increments_to_ages(topology, torch.nn.functional.softplus(theta), schedule)
        per_site = _category_log_likelihoods(
            topology, ages_to_lengths(topology, ages), leaves, n_states, None, rates, freqs,
            sequences_are_masks, levels)[0]
        loss = -_masked_sum(per_site, site_weights)
        loss.backward()
        losses[step] = loss.detach()
        optimizer.step()
    ages = increments_to_ages(topology, torch.nn.functional.softplus(theta.detach()), schedule)
    return ages, losses


def clock_lrt(
    topology: Topology,
    leaf_sequences,
    n_states: int,
    *,
    sequences_are_masks: bool = False,
    site_weights=None,
    rates=None,
    freqs=None,
    n_iterations: int = 600,
) -> dict:
    """Likelihood-ratio test of the strict clock on a fixed topology: H0
    ultrametric (n - 1 free ages), H1 free lengths (2n - 3 identifiable);
    2 (lnL1 - lnL0) ~ chi2(n - 2). Returns lnl_clock, lnl_free, statistic,
    df, p_value (scipy's chi2 survival function) and the fitted ages."""
    from scipy.stats import chi2

    from trex_tpu_torch.ops.likelihood import optimize_branch_lengths, tree_log_likelihood

    leaves = torch.as_tensor(leaf_sequences)
    topology = topology.to(leaves.device)
    kwargs = dict(sequences_are_masks=sequences_are_masks, rates=rates, freqs=freqs)
    ages, _ = optimize_clock(topology, leaves, n_states, site_weights=site_weights,
                             n_iterations=n_iterations, **kwargs)
    lnl_clock = float(tree_log_likelihood(
        topology, ages_to_lengths(topology, ages), leaves, n_states, site_mask=site_weights,
        **kwargs))
    free_lengths, _ = optimize_branch_lengths(
        topology, leaves, n_states, site_weights=site_weights, n_iterations=n_iterations,
        **kwargs)
    lnl_free = float(tree_log_likelihood(topology, free_lengths, leaves, n_states,
                                         site_mask=site_weights, **kwargs))
    stat = max(2.0 * (lnl_free - lnl_clock), 0.0)
    df = topology.n_leaves - 2
    return {"lnl_clock": lnl_clock, "lnl_free": lnl_free, "statistic": stat, "df": df,
            "p_value": float(chi2.sf(stat, df)), "ages": ages.cpu().numpy()}
