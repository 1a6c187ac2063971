"""Sharded candidate scoring, scans and training steps over the ranks of a
('tree', 'site') mesh (counterpart of ``trex_tpu/parallel/sharded.py``).

Every rank runs the same calls with the same (replicated) inputs and takes
its own part: a block of the candidate trees (or prune rows, or restarts)
by its ``tree`` coordinate and a block of the sites by its ``site``
coordinate. What makes both axes cheap: every objective here is a sum over
sites (Fitch and Sankoff totals, pruning log-likelihoods, the surrogate
cost), so a site shard's partial scores merge with one ``psum`` over
``site``, and each tree is independent of the others, so the tree axis
needs only a gather of its results.

The kernels are the single-device ones, on the rank's tile: K1 (Fitch,
Hamming costs up to 32 states) or K5 (Sankoff) through
``ops.dispatch.batched_scores_fastest``, K4's per-branch mode for
likelihoods, the batched Newton fit and K4's per-site mode for per-site
rows, and the analytic scans (``ops.spr_scan``, ``ops.likelihood_scan``).
Parsimony partial sums are integer-valued, so the psum's order leaves them
exact; likelihood site shards sum in another order (about 1e-7 relative).

Every function takes ``mesh=None`` as this rank alone (``local_mesh``: a
1 x 1 mesh whose collectives are the identity), which is how the search
modules run on one device: the same calls, no second path.

Padding, as the JAX package's mesh paths pad: sites to a multiple of S
with weight-0 columns (state 0 or its mask, or the full mask for
likelihoods), trees to a multiple of T by repeating the last tree, sliced
off again after the gather.
"""

from __future__ import annotations

import numpy as np
import torch

from trex_tpu_torch.parallel.mesh import SITE_AXIS, TREE_AXIS, Mesh, local_mesh
from trex_tpu_torch.topology import Topology


def site_shard(mesh: Mesh, leaf_sequences, site_weights=None, pad_value: int = 0):
    """This rank's (leaves (n, L'), weights (L',)) columns: the sites padded
    to a multiple of the ``site`` axis with weight-0 columns of
    ``pad_value``, then the rank's contiguous block of L' = L_padded / S."""
    leaves = torch.as_tensor(leaf_sequences)
    length = leaves.shape[-1]
    weights = (
        torch.ones((length,), dtype=torch.float32, device=leaves.device)
        if site_weights is None
        else torch.as_tensor(site_weights, device=leaves.device).to(torch.float32)
    )
    n_site = mesh.shape[SITE_AXIS]
    pad = -length % n_site
    if pad:
        leaves = torch.cat([leaves, torch.full((leaves.shape[0], pad), pad_value,
                                               dtype=leaves.dtype, device=leaves.device)], 1)
        weights = torch.cat([weights, weights.new_zeros((pad,))])
    width = (length + pad) // n_site
    lo = mesh.site_index * width
    return leaves[:, lo:lo + width].contiguous(), weights[lo:lo + width].contiguous()


def tree_block(mesh: Mesh, rows: torch.Tensor) -> torch.Tensor:
    """This rank's block of ``rows`` (a leading batch axis), padded to a
    multiple of the ``tree`` axis by repeating the last row."""
    n_tree = mesh.shape[TREE_AXIS]
    pad = -rows.shape[0] % n_tree
    if pad:
        rows = torch.cat([rows, rows[-1:].expand(pad, *rows.shape[1:])])
    size = rows.shape[0] // n_tree
    return rows[mesh.tree_index * size:(mesh.tree_index + 1) * size]


def gather_trees(mesh: Mesh, local: torch.Tensor, n: int) -> torch.Tensor:
    """The first ``n`` rows of every rank's ``tree_block`` result, gathered
    over ``tree`` in rank order (what every rank holds afterwards)."""
    gathered = mesh.all_gather(local, TREE_AXIS)
    return gathered.reshape(-1, *local.shape[1:])[:n]


def _tile_scores(topologies: Topology, cost_matrix, leaves, weights, use_fitch,
                 sequences_are_masks):
    from trex_tpu_torch.ops.dispatch import batched_scores_fastest
    from trex_tpu_torch.ops.fitch import batched_fitch_score
    from trex_tpu_torch.ops.sankoff_cuda import batched_sankoff_score_cuda

    if use_fitch is None:
        return batched_scores_fastest(topologies, cost_matrix, leaves, weights,
                                      sequences_are_masks=sequences_are_masks)
    if use_fitch:
        return batched_fitch_score(topologies, leaves, weights,
                                   sequences_are_masks=sequences_are_masks,
                                   n_states=cost_matrix.shape[-1])
    device = leaves.device
    return batched_sankoff_score_cuda(
        topologies.children.to(device=device, dtype=torch.int32).contiguous(),
        leaves.to(torch.int32).contiguous(),
        torch.as_tensor(cost_matrix, device=device).to(torch.float32).contiguous(),
        weights, hamming=False, sequences_are_masks=sequences_are_masks)


def mesh_score_batch(mesh: Mesh | None, leaf_sequences, site_weights=None,
                     sequences_are_masks: bool = False, use_fitch: bool | None = None):
    """A ``score_batch_fn`` ``(topologies, cost_matrix, leaves) -> (B,)``
    scoring across the mesh (the ``leaves`` argument is ignored: the
    rank's site shard of ``leaf_sequences`` is cut once, here). The
    candidates are split over ``tree``, the sites over ``site``; the scores
    are the single-device dispatcher's bit for bit."""
    mesh = mesh or local_mesh()
    leaves, weights = site_shard(mesh, leaf_sequences, site_weights,
                                 1 if sequences_are_masks else 0)

    def score(topologies: Topology, cost_matrix, _leaves=None) -> torch.Tensor:
        n = topologies.children.shape[0]
        block = Topology(tree_block(mesh, topologies.children),
                         tree_block(mesh, topologies.parents))
        partial = _tile_scores(block, cost_matrix, leaves, weights, use_fitch,
                               sequences_are_masks)
        return gather_trees(mesh, mesh.psum(partial, SITE_AXIS), n)

    return score


def sharded_batch_scores(
    mesh: Mesh,
    topologies: Topology,
    cost_matrix: torch.Tensor,
    leaf_sequences,
    use_fitch: bool | None = None,
    *,
    site_weights=None,
    sequences_are_masks: bool = False,
) -> torch.Tensor:
    """Score a candidate-tree batch across the whole mesh.

    Each rank scores its (trees x sites) tile, the per-tree site partials
    merge with one ``psum`` over ``site`` and the rank blocks with one
    ``all_gather`` over ``tree``. ``use_fitch``: None picks the kernel from
    the cost (``ops.dispatch``: K1 for Hamming with Q <= 32, else K5), True
    Fitch, False Sankoff. Returns the (B,) scores on every rank; any B and
    L (padded as the module docstring says).
    """
    return mesh_score_batch(mesh, leaf_sequences, site_weights, sequences_are_masks,
                            use_fitch)(topologies, cost_matrix)


def sharded_best_tree(
    mesh: Mesh,
    topologies: Topology,
    cost_matrix: torch.Tensor,
    leaf_sequences,
    use_fitch: bool | None = None,
    *,
    site_weights=None,
    sequences_are_masks: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Score a candidate batch and select the best across the mesh: each
    rank's block reduces to (min, global index), then one ``all_gather``
    of those pairs over ``tree``. Ties go to the lowest tree rank, then the
    lowest local index: the lowest global index among equal minima.
    Returns (global_index, best_score), the same on every rank."""
    mesh = mesh or local_mesh()
    leaves, weights = site_shard(mesh, leaf_sequences, site_weights,
                                 1 if sequences_are_masks else 0)
    block = Topology(tree_block(mesh, topologies.children), tree_block(mesh, topologies.parents))
    scores = mesh.psum(_tile_scores(block, cost_matrix, leaves, weights, use_fitch,
                                    sequences_are_masks), SITE_AXIS)
    local = int(torch.argmin(scores))
    pair = torch.stack([scores[local].to(torch.float64),
                        torch.tensor(float(mesh.tree_index * scores.shape[0] + local),
                                     dtype=torch.float64, device=scores.device)])
    pairs = mesh.all_gather(pair, TREE_AXIS)
    winner = int(torch.argmin(pairs[:, 0]))
    return pairs[winner, 1].to(torch.int64), pairs[winner, 0].to(torch.float32)


def mesh_log_likelihoods(mesh: Mesh | None, leaf_sequences, n_states: int, site_weights=None,
                         sequences_are_masks: bool = False):
    """``lnl(children (B, n_anc, 2), branch_lengths) -> (B,)``: JC69
    log-likelihoods across the mesh, K4's per-branch mode on each rank's
    (trees x sites) tile with the P table built from the rank's
    branch-length rows, one ``psum`` over ``site`` and one ``all_gather``
    over ``tree``. ``branch_lengths``: (B, n_all), or one float for every
    branch of every candidate (the table is then one matrix broadcast, as
    the ML bootstrap ranks). The rank's site shard is cut once, here."""
    from trex_tpu_torch.ops.likelihood import jc69_transition
    from trex_tpu_torch.ops.likelihood_cuda import batched_log_likelihood_cuda

    mesh = mesh or local_mesh()
    full = (1 << n_states) - 1 if sequences_are_masks else 0
    leaves, weights = site_shard(mesh, leaf_sequences, site_weights, full)
    leaves = leaves.to(torch.int32)
    prior = torch.full((n_states,), 1.0 / n_states, device=leaves.device)

    def lnl(children: torch.Tensor, branch_lengths: torch.Tensor | float) -> torch.Tensor:
        n = children.shape[0]
        kids = tree_block(mesh, children).to(device=leaves.device, dtype=torch.int32)
        if isinstance(branch_lengths, (int, float)):
            p = jc69_transition(torch.tensor(float(branch_lengths), device=leaves.device),
                                n_states).expand(kids.shape[0], kids.shape[1] * 2 + 1,
                                                 n_states, n_states)
        else:
            p = jc69_transition(tree_block(mesh, torch.as_tensor(branch_lengths)), n_states)
        partial = batched_log_likelihood_cuda(
            kids.contiguous(), leaves, weights, prior, p.to(leaves.device).contiguous(),
            sequences_are_masks=sequences_are_masks)
        return gather_trees(mesh, mesh.psum(partial, SITE_AXIS), n)

    return lnl


def sharded_log_likelihoods(
    mesh: Mesh,
    topologies: Topology,
    branch_lengths,
    leaf_sequences,
    n_states: int,
    *,
    site_weights=None,
    sequences_are_masks: bool = False,
) -> torch.Tensor:
    """(B,) JC69 log-likelihoods of a candidate batch across the whole mesh,
    laid out as ``sharded_batch_scores`` (``mesh_log_likelihoods``); the
    same on every rank."""
    return mesh_log_likelihoods(mesh, leaf_sequences, n_states, site_weights,
                                sequences_are_masks)(topologies.children, branch_lengths)


def sharded_per_site_matrix(
    mesh: Mesh | None,
    trees: Topology,
    leaf_sequences,
    n_states: int,
    *,
    rates=None,
    freqs=None,
    weights=None,
    n_sweeps: int = 8,
    sequences_are_masks: bool = False,
    chunk: int | None = None,
    timings: dict | None = None,
) -> torch.Tensor:
    """(M, P) per-site log-likelihood rows, the candidate axis over ``tree``.

    The RELL primitive of ``search.alrt``, ``search.ufboot`` and
    ``search.topotest``: each rank runs ``ops.likelihood_asr.per_site_matrix``
    (the batched Newton fit, then K4's per-site mode) on its block of the
    candidates (padded by repeating the last), with every site; the rows
    come back with one ``all_gather`` over ``tree``. A candidate's row does
    not depend on the others in its chunk. ``chunk`` and ``timings`` as
    ``per_site_matrix``'s (this rank's part).
    """
    from trex_tpu_torch.ops.likelihood_asr import per_site_matrix

    mesh = mesh or local_mesh()
    block = Topology(tree_block(mesh, trees.children), tree_block(mesh, trees.parents))
    rows = per_site_matrix(block, leaf_sequences, n_states, rates, freqs, weights,
                           n_sweeps=n_sweeps, sequences_are_masks=sequences_are_masks,
                           chunk=chunk, timings=timings)
    return gather_trees(mesh, rows, int(trees.children.shape[0]))


def _scan_segments(
    topology: Topology,
    leaf_sequences,
    site_weights,
    *,
    sequences_are_masks: bool,
    criterion: str,
    ranking_branch_length: float,
    n_states: int | None,
    rates,
    freqs,
    gamma_shape,
    category_rates,
    category_weights,
    local_rows: int,
    max_cells: int | None,
):
    """(scan(prune_nodes) -> (scores (P, n_all), base), segment rows): the
    scan of ``criterion`` with its prune chunk sized from the device's scan
    budget, and how many of a rank's ``local_rows`` one call takes
    (``ops.spr_scan.segment_rows``, as the single-device scans size their
    segments)."""
    from trex_tpu_torch.ops.spr_scan import segment_rows, spr_scan
    from trex_tpu_torch.utils import chunking

    leaves = torch.as_tensor(leaf_sequences)
    n_all = topology.n_all
    length = leaves.shape[-1]
    scan_budget_bytes = chunking.scan_budget_bytes(leaves.device)
    seg = segment_rows(local_rows, n_all, leaves.device, max_cells)
    if criterion == "parsimony":
        # Per prune variant: the f32 set tables inside and upstream, as the
        # single-device climb counts them.
        prune_chunk = chunking.auto_prune_chunk(seg, n_all * length * 4 * 2,
                                                scan_budget_bytes)

        def scan(pn):
            return spr_scan(topology, leaves, site_weights,
                            sequences_are_masks=sequences_are_masks,
                            prune_nodes=pn, prune_chunk=prune_chunk)
    elif criterion == "ml":
        from trex_tpu_torch.ops.likelihood_scan import likelihood_spr_scan

        q = n_states or int(leaves.max()) + 1
        if category_rates is not None:
            n_cat = len(category_rates)
        elif gamma_shape is not None:
            n_cat = 4
        else:
            n_cat = 0
        # (Q+1)-wide f32 inside and upstream tables a variant, and a per-site
        # table a category under a mixture (the single-device ML climb's count).
        prune_chunk = chunking.auto_prune_chunk(
            seg, n_all * length * 4 * ((q + 1) * 2 + n_cat), scan_budget_bytes)

        def scan(pn):
            return likelihood_spr_scan(
                topology, leaves, q, ranking_branch_length, site_weights,
                rates=rates, freqs=freqs, gamma_shape=gamma_shape,
                category_rates=category_rates, category_weights=category_weights,
                sequences_are_masks=sequences_are_masks, prune_nodes=pn,
                prune_chunk=prune_chunk)
    else:
        raise ValueError(f"unknown criterion {criterion!r}")
    return scan, seg


def _rank_rows(mesh: Mesh, n_prune: int) -> tuple[np.ndarray, int]:
    """(this rank's ``local`` prune rows, how many of them are its own):
    rank d takes rows d * local .. (d + 1) * local - 1 of the prune axis
    padded to a multiple of the ``tree`` axis by repeating the last node
    (the JAX package's ``dev_rows``)."""
    n_tree = mesh.shape[TREE_AXIS]
    local = -(-n_prune // n_tree)
    first = mesh.tree_index * local
    rows = np.minimum(first + np.arange(local), n_prune - 1)
    return rows, max(0, min(local, n_prune - first))


def sharded_spr_scan(
    mesh: Mesh | None,
    topology: Topology,
    leaf_sequences,
    site_weights=None,
    *,
    sequences_are_masks: bool = False,
    criterion: str = "parsimony",
    ranking_branch_length: float = 0.1,
    n_states: int | None = None,
    rates=None,
    freqs=None,
    gamma_shape=None,
    category_rates=None,
    category_weights=None,
    max_cells: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The analytic all-SPR scan with the PRUNE axis over ``tree``.

    Each prune variant's up/down pass is independent, so rank d scans its
    block of prune rows (``_rank_rows``) with every site, in segments of at
    most ``max_cells`` cells (default from the device's memory), and the
    (n_all - 1, n_all) table comes back with one ``all_gather`` over
    ``tree``. Criterion ``"parsimony"`` (unit-cost Fitch) or ``"ml"``
    (fixed ranking lengths, optional GTR and rate mixture). Rows are
    computed whole, so the table is the single-device scan's.

    Returns (scores (n_all, n_all) with the all-inf root row, base_score),
    the same on every rank; for the decay analysis, which reads the whole
    table. The climbers take ``sharded_spr_scan_best``.
    """
    mesh = mesh or local_mesh()
    n_all = topology.n_all
    n_prune = n_all - 1
    rows, _ = _rank_rows(mesh, n_prune)
    scan, seg = _scan_segments(
        topology, leaf_sequences, site_weights, sequences_are_masks=sequences_are_masks,
        criterion=criterion, ranking_branch_length=ranking_branch_length, n_states=n_states,
        rates=rates, freqs=freqs, gamma_shape=gamma_shape, category_rates=category_rates,
        category_weights=category_weights, local_rows=rows.size, max_cells=max_cells)
    parts = []
    for s0 in range(0, rows.size, seg):
        scores, base = scan(torch.as_tensor(rows[s0:s0 + seg], dtype=torch.int64))
        parts.append(scores)
    table = gather_trees(mesh, torch.cat(parts), n_prune)
    root_row = torch.full((1, n_all), torch.inf, dtype=table.dtype, device=table.device)
    return torch.cat([table, root_row]), base


def sharded_spr_scan_best(
    mesh: Mesh | None,
    topology: Topology,
    leaf_sequences,
    site_weights=None,
    *,
    sequences_are_masks: bool = False,
    criterion: str = "parsimony",
    ranking_branch_length: float = 0.1,
    n_states: int | None = None,
    rates=None,
    freqs=None,
    gamma_shape=None,
    category_rates=None,
    category_weights=None,
    max_cells: int | None = None,
) -> tuple[float, int, int, float, int]:
    """The best SPR move of ``sharded_spr_scan``'s table without the table.

    Each rank reduces its own prune rows, segment by segment on the device,
    to (min, flat index, finite count); one ``all_gather`` of those scalars
    over ``tree`` picks the move. The move is ``np.argmin`` of the whole
    table: among equal minima the lowest prune row, then the lowest regraft
    column (the flat index p * n_all + v orders them so). The finite counts
    are summed. Arguments as ``sharded_spr_scan``'s.

    Returns (best_score, prune_node, regraft_node, base_score, n_finite),
    the same on every rank.
    """
    from trex_tpu_torch.ops.spr_scan import _segment_best

    mesh = mesh or local_mesh()
    n_all = topology.n_all
    n_prune = n_all - 1
    rows, own = _rank_rows(mesh, n_prune)
    scan, seg = _scan_segments(
        topology, leaf_sequences, site_weights, sequences_are_masks=sequences_are_masks,
        criterion=criterion, ranking_branch_length=ranking_branch_length, n_states=n_states,
        rates=rates, freqs=freqs, gamma_shape=gamma_shape, category_rates=category_rates,
        category_weights=category_weights, local_rows=rows.size, max_cells=max_cells)
    mins, flats, counts = [], [], []
    for s0 in range(0, rows.size, seg):
        pn = torch.as_tensor(rows[s0:s0 + seg], dtype=torch.int64)
        scores, base = scan(pn)
        m, idx, count = _segment_best(scores, min(max(own - s0, 0), pn.shape[0]))
        mins.append(m.to(torch.float64))
        flats.append((int(rows[s0]) * n_all + idx).to(torch.float64))
        counts.append(count.to(torch.float64))
    mins, flats = torch.stack(mins), torch.stack(flats)
    best = mins.min()
    local = torch.stack([best, torch.where(mins == best, flats, torch.inf).min(),
                         torch.stack(counts).sum(), base.to(torch.float64)])
    table = mesh.all_gather(local, TREE_AXIS)  # (T, 4)
    best = table[:, 0].min()
    flat = torch.where(table[:, 0] == best, table[:, 1], torch.inf).min()
    best, flat, n_finite, base = torch.stack(
        [best, flat, table[:, 2].sum(), table[0, 3]]).tolist()
    p, v = divmod(int(flat), n_all)
    return best, p, v, base, int(n_finite)


def _local_joint_loss(params, leaf_shard, noise, temperature, constraint_scale, n_leaves,
                      site_weight):
    """A rank's joint loss: its sites' surrogate cost plus the constraint
    penalty weighted by ``site_weight`` = 1 / S, so the penalty, which every
    site shard computes, counts once in the loss's psum."""
    from trex_tpu_torch.ops.costs import surrogate_cost
    from trex_tpu_torch.ops.relax import binary_tree_penalty, soft_sequences, soft_topology

    seqs = soft_sequences(params["ancestors"], leaf_shard, n_leaves, temperature)
    tree = soft_topology(params["tree_params"], noise=noise)
    penalty = temperature * binary_tree_penalty(tree, constraint_scale)
    return surrogate_cost(seqs, tree) + site_weight * penalty


def make_sharded_joint_step(
    mesh: Mesh,
    optimizer: torch.optim.Optimizer,
    n_leaves: int,
    constraint_scale: float = 10.0,
):
    """A training step of the joint search with the sites over ``site``.

    The rank holds its site shard of the ancestor logits (axis -2, the
    sites) and a replica of the topology logits: ``params`` is a dict of
    leaf tensors that require grad (``shard_joint_params``), and
    ``optimizer`` steps them. The step takes autograd grads of the rank's
    loss; the ancestor grads are exact as they are (site-local
    parameters), the topology grads merge with a ``psum`` over ``site``, as
    does the loss; then the optimizer steps (the port's
    ``search.optimizers``; Adam, SGD and RMSprop work element by element,
    so the step is the single-device one; a global-norm clip sees the
    rank's grads, as in the JAX package).

    Returns ``step(params, leaf_shard, noise, temperature) -> loss``, the
    loss summed over the sites (a 0-d tensor for one restart's params;
    or (R',) for a restart batch). ``noise`` is the
    step's Gumbel noise, shaped like the topology logits.
    """
    n_site = mesh.shape[SITE_AXIS]

    def step(params, leaf_shard, noise, temperature):
        optimizer.zero_grad(set_to_none=True)
        loss = _local_joint_loss(params, leaf_shard, noise, temperature, constraint_scale,
                                 n_leaves, 1.0 / n_site)
        loss.sum().backward()
        loss = mesh.psum(loss.detach().clone(), SITE_AXIS)
        mesh.psum(params["tree_params"].grad, SITE_AXIS)
        optimizer.step()
        return loss

    return step


# The JAX package's name for the step over a restart batch: the same step,
# with params that carry a leading restart axis (the rank's block,
# ``shard_joint_params(..., restarts=True)``) and an optimizer built with
# ``batched=True`` for a per-restart clip; it returns the (R',) losses.
make_sharded_restart_joint_step = make_sharded_joint_step


def shard_joint_params(mesh: Mesh, params: dict, leaf_tensor: torch.Tensor, *,
                       restarts: bool = False):
    """(params, leaf_shard): this rank's part of the joint search's inputs,
    as fresh leaf tensors that require grad: the ancestor logits' and the
    (n_all, L, Q) leaf tensor's site block (the sites divide by S), and
    with ``restarts`` the rank's block of the leading restart axis (which
    divides by T)."""
    n_site = mesh.shape[SITE_AXIS]
    length = leaf_tensor.shape[-2]
    if length % n_site:
        raise ValueError(f"{length} sites do not divide over {n_site} site shards")
    width = length // n_site
    cols = slice(mesh.site_index * width, (mesh.site_index + 1) * width)
    out = {}
    for name, value in params.items():
        if restarts:
            n_tree = mesh.shape[TREE_AXIS]
            if value.shape[0] % n_tree:
                raise ValueError(f"{value.shape[0]} restarts do not divide over {n_tree} "
                                 "tree shards")
            value = tree_block(mesh, value)
        if name == "ancestors":
            value = value[..., cols, :]
        out[name] = value.detach().clone().requires_grad_(True)
    return out, leaf_tensor[..., cols, :].contiguous()


def sharded_joint_step(
    mesh: Mesh,
    params: dict,
    leaf_shard: torch.Tensor,
    noise: torch.Tensor,
    temperature,
    optimizer: torch.optim.Optimizer,
    n_leaves: int,
    constraint_scale: float = 10.0,
):
    """One step of ``make_sharded_joint_step`` (a one-shot convenience)."""
    step = make_sharded_joint_step(mesh, optimizer, n_leaves, constraint_scale)
    return step(params, leaf_shard, noise, temperature)
