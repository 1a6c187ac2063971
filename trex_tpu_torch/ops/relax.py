"""Differentiable relaxations: soft topologies, soft sequences, constraints
(counterpart of ``trex_tpu/ops/relax.py``).

Conventions kept from the reference (the optimisation dynamics depend on
them):

- ``soft_topology`` *divides* logits by the temperature while
  ``soft_sequences`` *multiplies* by it — asymmetric on purpose.
- Topology masks: leaves attach only to ancestors; the ancestor -> ancestor
  block is strictly upper triangular (acyclic); the root's self-logit is
  pinned to 1.0 before the softmax.
- ``joint_loss`` runs the topology softmax at temperature 1.0 and scales
  only the constraint penalty by the annealed temperature.

Parameters are stacked tensors (``ancestors: (n_anc, L, Q)``); every
function also takes leading batch axes (restarts). Where the JAX package
draws Gumbel noise from a key, these functions take the noise as a tensor,
or draw it from a ``torch.Generator`` (``gumbel``).
"""

from __future__ import annotations

import functools

import torch

from trex_tpu_torch.ops.costs import surrogate_cost
from trex_tpu_torch.topology import Topology


def gumbel(
    shape, *, generator: torch.Generator | None = None, device=None,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Standard Gumbel noise drawn as ``jax.random.gumbel`` draws it:
    ``-log(-log(U))`` with U uniform in [tiny, 1), so no draw is infinite."""
    if generator is not None and device is None:
        device = generator.device
    u = torch.rand(shape, generator=generator, device=device, dtype=dtype)
    return -torch.log(-torch.log(u.clamp_(min=torch.finfo(dtype).tiny)))


def soft_topology(
    tree_logits: torch.Tensor,
    temperature: float | torch.Tensor = 1.0,
    gates: torch.Tensor | None = None,
    *,
    noise: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """Gumbel-softmax relaxed tree topology.

    Args:
        tree_logits: (..., n_all - 1, n_ancestors) parent-assignment logits
            of every non-root node.
        temperature: the perturbed logits are divided by it.
        gates: optional multiplicative gates on the perturbed logits.
        noise: the Gumbel noise, shaped like ``tree_logits``; drawn from
            ``generator`` (on the logits' device) when None.

    Returns:
        (..., n_all, n_all) row-stochastic soft adjacency: row i is node i's
        parent distribution. Only ancestor columns can be non-zero; the
        softmax runs over them alone, which gives the full row softmax's
        values (its other logits are -inf).
    """
    *batch, n_rows, n_anc = tree_logits.shape
    n_all = n_rows + 1
    n_leaves = n_all - n_anc
    if n_anc == 0:
        return torch.eye(n_all, dtype=tree_logits.dtype, device=tree_logits.device).expand(
            *batch, n_all, n_all)
    if noise is None:
        noise = gumbel(tree_logits.shape, generator=generator, device=tree_logits.device,
                       dtype=tree_logits.dtype)
    perturbed = tree_logits + noise
    if gates is not None:
        perturbed = perturbed * gates
    perturbed = perturbed / temperature
    mask, root = _topology_mask(n_leaves, n_anc, perturbed.dtype, perturbed.device)
    logits = torch.cat([perturbed + mask, root.expand(*batch, 1, n_anc)], dim=-2)
    return torch.nn.functional.pad(torch.softmax(logits, dim=-1), (n_leaves, 0))


@functools.lru_cache(maxsize=64)
def _topology_mask(n_leaves: int, n_anc: int, dtype: torch.dtype, device: torch.device):
    """The structural logits of ``soft_topology``: a (n_all - 1, n_anc) mask,
    0 where a node may attach and -inf where not (ancestor i attaches only
    to ancestors j > i), and the root's (1, n_anc) row, -inf but for its
    pinned self-logit of 1.0."""
    rows = torch.arange(n_anc - 1, device=device)[:, None]
    cols = torch.arange(n_anc, device=device)[None, :]
    mask = torch.zeros((n_leaves + n_anc - 1, n_anc), dtype=dtype, device=device)
    mask[n_leaves:].masked_fill_(cols <= rows, float("-inf"))
    root = torch.full((1, n_anc), float("-inf"), dtype=dtype, device=device)
    root[0, -1] = 1.0
    return mask, root


def soft_sequences(
    ancestor_logits: torch.Tensor,
    sequences: torch.Tensor,
    n_leaves: int,
    temperature: float | torch.Tensor = 1.0,
) -> torch.Tensor:
    """(..., N, L, Q): ``sequences`` with its ancestor rows replaced by the
    softmax of ``ancestor_logits * temperature`` (multiplied, as the
    reference does). Leading axes of the logits broadcast over the
    sequences."""
    soft = torch.softmax(ancestor_logits * temperature, dim=-1).to(sequences.dtype)
    leaves = sequences[..., :n_leaves, :, :]
    if soft.dim() > leaves.dim():
        leaves = leaves.expand(*soft.shape[:-3], *leaves.shape[-3:])
    elif leaves.dim() > soft.dim():
        soft = soft.expand(*leaves.shape[:-3], *soft.shape[-3:])
    return torch.cat([leaves, soft], dim=-3)


def discretize_topology(soft_adjacency: torch.Tensor) -> torch.Tensor:
    """One-hot row argmax of a soft adjacency (ties to the first index)."""
    n = soft_adjacency.shape[-1]
    return torch.nn.functional.one_hot(soft_adjacency.argmax(-1), n).to(torch.float32)


def project_topology(soft_adjacency: torch.Tensor) -> Topology:
    """Project soft adjacencies onto the nearest-greedy valid ``Topology``.

    Ancestors in increasing index order each claim the two still-unassigned
    lower-indexed nodes with the largest soft weight toward them; before
    ancestor ``j`` exactly ``n_leaves - j`` candidates remain, so the result
    is always a valid tree under the node convention (children precede
    parents, root last). Ties go to the first index, as ``jnp.argmax``'s.

    Args:
        soft_adjacency: (..., n_all, n_all) row-stochastic soft adjacencies;
            leading axes (restarts) are projected together on their device.

    Returns:
        ``Topology`` with the same leading axes.
    """
    *batch, n_all, _ = soft_adjacency.shape
    n_anc = (n_all - 1) // 2
    n_leaves = n_anc + 1
    device = soft_adjacency.device
    w = soft_adjacency[..., :-1, n_leaves:].reshape(-1, n_all - 1, n_anc)
    flat = w.shape[0]
    idx = torch.arange(n_all - 1, device=device)
    avail = torch.ones((flat, n_all - 1), dtype=torch.bool, device=device)
    children = torch.empty((flat, n_anc, 2), dtype=torch.int64, device=device)
    neg_inf = torch.tensor(float("-inf"), dtype=w.dtype, device=device)
    for j in range(n_anc):
        wj = torch.where(avail & (idx < n_leaves + j), w[:, :, j], neg_inf)
        c1 = wj.argmax(-1, keepdim=True)
        c2 = wj.scatter(-1, c1, neg_inf.expand_as(c1)).argmax(-1, keepdim=True)
        avail.scatter_(-1, c1, False)
        avail.scatter_(-1, c2, False)
        children[:, j] = torch.cat([torch.minimum(c1, c2), torch.maximum(c1, c2)], -1)
    anc = torch.arange(n_leaves, n_all, device=device).expand(flat, n_anc)
    parents = torch.full((flat, n_all), n_all - 1, dtype=torch.int64, device=device)
    parents.scatter_(-1, children[:, :, 0], anc)
    parents.scatter_(-1, children[:, :, 1], anc)
    return Topology(
        children.to(torch.int32).reshape(*batch, n_anc, 2),
        parents.to(torch.int32).reshape(*batch, n_all),
    )


def binary_tree_penalty(
    soft_adjacency: torch.Tensor, scale: float | torch.Tensor
) -> torch.Tensor:
    """``scale * sum_ancestors (col_sum - 2)^2`` over the ancestor columns
    of the soft adjacency, root row excluded: pushes every ancestor to
    exactly two children."""
    n_all = soft_adjacency.shape[-1]
    n_ancestors = (n_all - 1) // 2
    child_mass = soft_adjacency[..., :-1, n_all - n_ancestors:].sum(-2)
    return scale * (child_mass - 2.0).square().sum(-1)


def joint_loss(
    params: dict[str, torch.Tensor],
    sequences: torch.Tensor,
    temperature: float | torch.Tensor,
    adjacency: torch.Tensor | None = None,
    *,
    noise: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
    constraint_scale: float = 10.0,
    fix_seqs: bool = False,
    fix_tree: bool = False,
) -> torch.Tensor:
    """Joint topology + sequence objective: surrogate(soft sequences, soft
    tree) + temperature * binary_tree_penalty. The topology softmax runs at
    temperature 1.0 whatever the annealed ``temperature``. ``noise`` is the
    topology's Gumbel noise (the JAX function draws it from the second half
    of its key's split); with ``fix_tree`` the ``adjacency`` is used
    instead, with ``fix_seqs`` the ``sequences`` as they are."""
    n_leaves = (sequences.shape[-3] + 1) // 2
    seqs = (
        sequences if fix_seqs
        else soft_sequences(params["ancestors"], sequences, n_leaves, temperature)
    )
    tree = (
        adjacency if fix_tree
        else soft_topology(params["tree_params"], noise=noise, generator=generator)
    )
    return surrogate_cost(seqs, tree) + temperature * binary_tree_penalty(
        tree, constraint_scale)


class _StraightThrough(torch.autograd.Function):
    @staticmethod
    def forward(ctx, soft_sequence):
        winners = soft_sequence.argmax(-1)
        ctx.save_for_backward(winners)
        ctx.n_states = soft_sequence.shape[-1]
        return winners.to(soft_sequence.dtype)

    @staticmethod
    def backward(ctx, grad_out):
        (winners,) = ctx.saved_tensors
        one_hot = torch.nn.functional.one_hot(winners, ctx.n_states).to(grad_out.dtype)
        return grad_out[..., None] * one_hot


def straight_through(soft_sequence: torch.Tensor) -> torch.Tensor:
    """Argmax forward, the gradient routed to the winning entry (the
    straight-through estimator). The winners come back as the input's
    float dtype (integer values) so that autograd carries a gradient
    through them; ``.long()`` gives the indices."""
    return _StraightThrough.apply(soft_sequence)
