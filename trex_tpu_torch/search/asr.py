"""Gradient-based ancestral sequence reconstruction on a fixed topology
(counterpart of ``trex_tpu/search/asr.py``).

- The descent is an eager loop of ``n_iterations`` optimizer steps.
- The NK "parental logits" marginalisation is vectorised over sites: one
  chained outer product over the K epistatic neighbours; ``site_chunk``
  cuts the site axis into chunks where q**K is large.
- Mixed precision keeps the parameters float32 and runs the forward pass
  in ``compute_dtype`` (bfloat16), as the reference's flag does.

Where the JAX package draws the initial logits from a key, these functions
take them as ``init`` or draw them from a ``torch.Generator``.
"""

from __future__ import annotations

from typing import Callable

import torch

from trex_tpu_torch.models.nk import NKLandscape
from trex_tpu_torch.ops.costs import soft_parsimony_cost, surrogate_cost
from trex_tpu_torch.ops.relax import soft_sequences
from trex_tpu_torch.search.optimizers import make_optimizer


def _masked_leaf_tensor(leaf_sequences, n_all, n_states, dtype):
    """(n_all, L, Q): one-hot leaves, zero ancestors."""
    n_leaves, length = leaf_sequences.shape
    out = torch.zeros((n_all, length, n_states), dtype=dtype, device=leaf_sequences.device)
    out[:n_leaves] = torch.nn.functional.one_hot(leaf_sequences.long(), n_states).to(dtype)
    return out


def _initial_logits(init, shape, dtype, generator, device) -> torch.Tensor:
    if init is None:
        return torch.randn(shape, generator=generator, device=device, dtype=dtype)
    return torch.as_tensor(init, device=device).to(dtype)


def _run_descent(
    loss_fn: Callable, ancestors: torch.Tensor, optimizer_name: str, learning_rate: float,
    n_iterations: int, return_losses: bool,
):
    """``n_iterations`` optimizer steps on a copy of ``ancestors`` (clipped
    at global norm 1.0, ``make_optimizer``'s default). Returns the final
    logits and, with ``return_losses``, the (n_iterations,) loss curve."""
    ancestors = ancestors.detach().clone().requires_grad_(True)
    optimizer = make_optimizer(optimizer_name, learning_rate, [ancestors])
    losses = []
    for _ in range(n_iterations):
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(ancestors)
        loss.backward()
        optimizer.step()
        if return_losses:
            losses.append(loss.detach())
    return ancestors.detach(), (torch.stack(losses) if return_losses else None)


def reconstruct_ancestors(
    leaf_sequences: torch.Tensor,
    n_all: int,
    n_states: int,
    adjacency: torch.Tensor,
    generator: torch.Generator | None = None,
    *,
    init: torch.Tensor | None = None,
    use_soft_cost: bool = False,
    optimizer_name: str = "adam",
    learning_rate: float = 1e-3,
    n_iterations: int = 10000,
    return_losses: bool = False,
    mixed_precision: bool = False,
    compute_dtype: torch.dtype = torch.float32,
):
    """Learn ancestor sequences on a fixed topology by gradient descent.

    Args:
        leaf_sequences: (n_leaves, L) integer observed states, on the device
            the descent runs on.
        adjacency: (n_all, n_all) fixed topology (dense, child -> parent).
        generator: draws the standard-normal initial logits when ``init``
            (n_ancestors, L, Q) is not given.
        use_soft_cost: the substitution-weighted soft cost (identity
            weights) instead of the plain surrogate.

    Returns:
        (n_ancestors, L) int32 argmax ancestors; and the (n_iterations,)
        loss curve when ``return_losses``.
    """
    n_leaves, length = leaf_sequences.shape
    device = leaf_sequences.device
    param_dtype = torch.float32 if mixed_precision else compute_dtype
    ancestors = _initial_logits(
        init, (n_all - n_leaves, length, n_states), param_dtype, generator, device)
    masked = _masked_leaf_tensor(leaf_sequences, n_all, n_states, compute_dtype)
    identity = torch.eye(n_states, dtype=compute_dtype, device=device)
    adjacency = adjacency.to(device=device, dtype=compute_dtype)

    def loss_fn(anc):
        seqs = soft_sequences(anc.to(compute_dtype), masked, n_leaves)
        if use_soft_cost:
            return soft_parsimony_cost(seqs, adjacency, identity)
        return surrogate_cost(seqs, adjacency)

    ancestors, losses = _run_descent(
        loss_fn, ancestors, optimizer_name, learning_rate, n_iterations, return_losses)
    result = ancestors.argmax(-1).to(torch.int32)
    return (result, losses) if return_losses else result


def parental_logits(
    parent_soft_seqs: torch.Tensor,
    landscape: NKLandscape,
    *,
    site_chunk: int | None = None,
) -> torch.Tensor:
    """Expected-fitness logits of each site and state under soft parent
    beliefs: the landscape's table marginalised over the parent's soft
    distribution at the K neighbour sites, for all sites at once.

    The table is split as the JAX function splits it (``tables.reshape(L,
    Q, q^K)``) and the neighbours' joint is the chained outer product in
    neighbour order, so the port computes the same function.

    Args:
        parent_soft_seqs: (P, L, Q) soft parent sequences.
        site_chunk: optional chunk of the site axis, to bound memory.

    Returns:
        (P, L, Q) logits.
    """
    n_parents, length, q = parent_soft_seqs.shape
    if landscape.k == 0:
        return landscape.tables[None].expand(n_parents, length, q).to(parent_soft_seqs.dtype)
    interactions = landscape.interactions.to(torch.int64)
    k_eff = interactions.shape[-1]
    tables = landscape.tables.reshape(length, q, -1)

    def logits_for_sites(site_ids):
        probs = parent_soft_seqs[:, interactions[site_ids], :]  # (P, l, K, Q)
        joint = probs[:, :, 0, :]
        for j in range(1, k_eff):
            joint = (joint[..., :, None] * probs[:, :, j, None, :]).flatten(-2)
        # (l, Q, q^K) x (P, l, q^K) -> (P, l, Q), accumulated in float32.
        out = torch.einsum("lsi,pli->pls", tables[site_ids].float(), joint.float())
        return out.to(parent_soft_seqs.dtype)

    sites = torch.arange(length, device=parent_soft_seqs.device)
    if site_chunk is None or site_chunk >= length:
        return logits_for_sites(sites)
    return torch.cat([logits_for_sites(chunk) for chunk in sites.split(site_chunk)], dim=1)


def landscape_aware_loss(
    ancestors: torch.Tensor,
    masked_sequences: torch.Tensor,
    n_leaves: int,
    landscape: NKLandscape,
    adjacency: torch.Tensor,
    lambda_val: float,
    *,
    temperature: float = 1.0,
    site_mask: torch.Tensor | None = None,
    site_chunk: int | None = None,
) -> torch.Tensor:
    """surrogate + lambda * parental-guidance cross-entropy.

    The fitness term is the masked cross-entropy between each node's soft
    states and the softmaxed expected-fitness logits of its parent,
    normalised by (non-root nodes x valid sites). Skipped when
    ``lambda_val`` is 0 or the landscape has no epistasis.
    """
    n_all, length = masked_sequences.shape[0], masked_sequences.shape[1]
    seqs = soft_sequences(ancestors, masked_sequences, n_leaves, temperature)
    cost = surrogate_cost(seqs, adjacency)
    if lambda_val == 0.0 or landscape.k == 0:
        return cost
    if site_mask is None:
        site_mask = torch.ones(length, dtype=torch.bool, device=seqs.device)
    parent_idx = adjacency.argmax(-1)
    logits = parental_logits(seqs[parent_idx], landscape, site_chunk=site_chunk)
    log_probs = torch.log_softmax(logits, dim=-1)
    per_site_ce = -(seqs * log_probs).sum(-1)  # (N, L)
    ce = (per_site_ce * site_mask[None, :]).sum()
    is_root = torch.arange(n_all, device=seqs.device) == parent_idx
    fitness_cost = ce / ((~is_root).sum() * site_mask.sum())
    return cost + lambda_val * fitness_cost


def reconstruct_ancestors_landscape_aware(
    leaf_sequences: torch.Tensor,
    n_all: int,
    n_states: int,
    landscape: NKLandscape,
    lambda_val: float,
    adjacency: torch.Tensor,
    generator: torch.Generator | None = None,
    *,
    init: torch.Tensor | None = None,
    optimizer_name: str = "adam",
    learning_rate: float = 1e-3,
    n_iterations: int = 10000,
    return_losses: bool = False,
    mixed_precision: bool = False,
    compute_dtype: torch.dtype = torch.float32,
    site_mask: torch.Tensor | None = None,
    site_chunk: int | None = None,
):
    """ASR under the landscape-aware objective (fixed topology); arguments
    and result as ``reconstruct_ancestors``."""
    n_leaves, length = leaf_sequences.shape
    device = leaf_sequences.device
    param_dtype = torch.float32 if mixed_precision else compute_dtype
    ancestors = _initial_logits(
        init, (n_all - n_leaves, length, n_states), param_dtype, generator, device)
    masked = _masked_leaf_tensor(leaf_sequences, n_all, n_states, compute_dtype)
    adjacency = adjacency.to(device=device, dtype=compute_dtype)

    def loss_fn(anc):
        return landscape_aware_loss(
            anc.to(compute_dtype), masked, n_leaves, landscape, adjacency, lambda_val,
            site_mask=site_mask, site_chunk=site_chunk,
        )

    ancestors, losses = _run_descent(
        loss_fn, ancestors, optimizer_name, learning_rate, n_iterations, return_losses)
    result = ancestors.argmax(-1).to(torch.int32)
    return (result, losses) if return_losses else result
