"""Joint topology + sequence optimisation and topology-only search
(counterpart of ``trex_tpu/search/joint.py``).

The "differentiable evolution tree search": anneal a Gumbel-softmax
topology and soft ancestor sequences against the surrogate parsimony cost
plus the binary-tree constraint.

Restarts are a leading batch axis of every parameter: one optimizer over
the stacked parameters is exact, because Adam, SGD, RMSprop and AdamW work
element by element and each restart's loss reads only its own slice (the
global-norm clip, where asked for, is taken per restart). The step loop is
eager PyTorch: about a hundred kernel launches a step on the card.

Where the JAX package draws from keys, these functions take the draws as
tensors (``init``, ``noise``) or draw them from a ``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from trex_tpu_torch._device import resolve_device
from trex_tpu_torch.ops.costs import exact_cost, surrogate_cost
from trex_tpu_torch.ops.relax import (
    binary_tree_penalty,
    discretize_topology,
    gumbel,
    soft_sequences,
    soft_topology,
)
from trex_tpu_torch.search.optimizers import make_optimizer

# Dimensions of one restart's parameters; more are leading restart axes.
_PARAM_DIMS = {"tree_params": 2, "ancestors": 3}


@dataclasses.dataclass(frozen=True)
class JointConfig:
    """Hyperparameters of the joint search (defaults = reference test setup)."""

    n_iterations: int = 5000
    learning_rate: float = 0.01
    optimizer: str = "adam"
    clip_global_norm: float | None = None
    temp_start: float = 2.0
    temp_end: float = 0.1
    constraint_scale: float = 10.0
    learn_sequences: bool = True
    learn_topology: bool = True


def anneal(cfg: JointConfig, steps: torch.Tensor, total_steps: int) -> torch.Tensor:
    """Temperatures of global ``steps`` of a ``total_steps`` schedule, the
    convergence test's ``max(temp_end, temp_start * (1 - step / total))``."""
    ramp = cfg.temp_start * (1.0 - steps.to(torch.float32) / total_steps)
    return torch.clamp(ramp, min=cfg.temp_end)


def _anneal(cfg: JointConfig, device=None) -> torch.Tensor:
    """The (n_iterations,) temperatures of ``joint_optimize``."""
    return anneal(cfg, torch.arange(cfg.n_iterations, device=device), cfg.n_iterations)


def init_params(
    n_leaves: int,
    seq_length: int,
    n_states: int,
    *,
    generator: torch.Generator | None = None,
    batch: tuple[int, ...] = (),
    device=None,
) -> dict[str, torch.Tensor]:
    """Standard-normal topology logits ``(*batch, n_all - 1, n_anc)`` and
    ancestor logits ``(*batch, n_anc, L, Q)``, drawn in that order from
    ``generator``, on ``device``: by default the generator's, or ``cuda``
    without one (raising when there is no card)."""
    if device is None:
        device = generator.device if generator is not None else "cuda"
    device = resolve_device(device)
    n_all = 2 * n_leaves - 1
    n_anc = n_leaves - 1
    return {
        "tree_params": torch.randn((*batch, n_all - 1, n_anc), generator=generator,
                                   device=device),
        "ancestors": torch.randn((*batch, n_anc, seq_length, n_states),
                                 generator=generator, device=device),
    }


def params_from_numpy(params: dict, device="cpu") -> dict[str, torch.Tensor]:
    """The port's float32 parameter tensors of a JAX parameter pytree
    (``init_params``' or a trained one: ``tree_params``, ``ancestors``),
    each given as an array (``np.asarray`` of the JAX array)."""
    return {
        name: torch.as_tensor(np.array(value, dtype=np.float32), device=device)
        for name, value in params.items()
    }


def is_batched(params: dict[str, torch.Tensor]) -> bool:
    return any(p.dim() > _PARAM_DIMS[name] for name, p in params.items())


def joint_loss_fn(
    leaf_tensor: torch.Tensor,
    cfg: JointConfig,
    fixed_adjacency: torch.Tensor | None = None,
    fixed_sequences: torch.Tensor | None = None,
) -> Callable:
    """``loss(params, temperature, noise) -> (...,)`` per-restart losses of
    the annealed joint objective. The topology softmax runs at temperature
    1; the anneal sets the constraint weight and the sequence softmax."""
    n_leaves = (leaf_tensor.shape[-3] + 1) // 2

    def loss(params, temperature, noise):
        if cfg.learn_sequences:
            seqs = soft_sequences(params["ancestors"], leaf_tensor, n_leaves, temperature)
        else:
            seqs = fixed_sequences
        if cfg.learn_topology:
            tree = soft_topology(params["tree_params"], noise=noise)
            penalty = temperature * binary_tree_penalty(tree, cfg.constraint_scale)
        else:
            tree = fixed_adjacency
            penalty = 0.0
        return surrogate_cost(seqs, tree) + penalty

    return loss


def run_steps(
    params: dict[str, torch.Tensor],
    optimizer: torch.optim.Optimizer,
    loss: Callable,
    temperatures: torch.Tensor,
    noise_at: Callable[[int], torch.Tensor],
    cfg: JointConfig,
) -> torch.Tensor:
    """Descend ``len(temperatures)`` steps in place on ``params`` (leaf
    tensors that require grad, the optimizer's): the loss at step ``i``
    takes ``temperatures[i]`` and the Gumbel noise ``noise_at(i)``. The
    gradient of a parameter that is not learned is multiplied by 0 (it
    stays in the optimizer, so AdamW still decays it, as optax does).
    Returns the (steps, ...) per-restart losses."""
    mask = {"tree_params": cfg.learn_topology, "ancestors": cfg.learn_sequences}
    losses = []
    for i in range(temperatures.shape[0]):
        optimizer.zero_grad(set_to_none=True)
        value = loss(params, temperatures[i], noise_at(i))
        value.sum().backward()
        for name, p in params.items():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            elif not mask[name]:
                p.grad.mul_(0.0)
        optimizer.step()
        losses.append(value.detach())
    return torch.stack(losses)


def joint_optimize(
    params: dict[str, torch.Tensor],
    leaf_tensor: torch.Tensor,
    cfg: JointConfig = JointConfig(),
    fixed_adjacency: torch.Tensor | None = None,
    fixed_sequences: torch.Tensor | None = None,
    *,
    noise: torch.Tensor | Callable[[int], torch.Tensor] | None = None,
    generator: torch.Generator | None = None,
):
    """Run the annealed joint search.

    Args:
        params: ``init_params`` tensors, optionally with a leading restart
            axis (R, ...); not modified.
        leaf_tensor: (n_all, L, Q) one-hot leaves, zero ancestor rows.
        fixed_adjacency: the topology held fixed when ``cfg.learn_topology``
            is False (soft or one-hot row-stochastic).
        fixed_sequences: the (N, L, Q) sequences held fixed when
            ``cfg.learn_sequences`` is False.
        noise: (n_iterations, [R,] n_all - 1, n_anc) Gumbel noise of the
            steps, or a function of the step that returns it; drawn from
            ``generator`` a step at a time when None.

    Returns:
        (params, losses): the optimised parameters and the (n_iterations,
        [R]) loss curve.
    """
    device = leaf_tensor.device
    params = {k: v.detach().clone().to(device).requires_grad_(True) for k, v in params.items()}
    shape = params["tree_params"].shape if "tree_params" in params else None
    if torch.is_tensor(noise):
        noise = noise.to(device)

    def noise_at(i):
        if not cfg.learn_topology:
            return None
        if callable(noise):
            return noise(i)
        if noise is not None:
            return noise[i]
        return gumbel(shape, generator=generator, device=device)

    optimizer = make_optimizer(
        cfg.optimizer, cfg.learning_rate, params.values(),
        clip_global_norm=cfg.clip_global_norm, batched=is_batched(params),
    )
    losses = run_steps(
        params, optimizer, joint_loss_fn(leaf_tensor, cfg, fixed_adjacency, fixed_sequences),
        _anneal(cfg, device), noise_at, cfg,
    )
    return {k: v.detach() for k, v in params.items()}, losses


def extract_solution(
    params: dict[str, torch.Tensor],
    leaf_tensor: torch.Tensor,
    eval_temperature: float = 0.01,
    *,
    noise: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
):
    """(soft_tree, hard_tree, soft_seqs): the evaluation-temperature soft
    adjacency (Gumbel ``noise``, or drawn from ``generator``), its one-hot
    discretisation and the near-hard sequences."""
    n_leaves = (leaf_tensor.shape[-3] + 1) // 2
    soft_tree = soft_topology(
        params["tree_params"], eval_temperature, noise=noise, generator=generator)
    hard_tree = discretize_topology(soft_tree)
    soft_seqs = soft_sequences(params["ancestors"], leaf_tensor, n_leaves, eval_temperature)
    return soft_tree, hard_tree, soft_seqs


def evaluate_solution(
    params: dict[str, torch.Tensor],
    leaf_tensor: torch.Tensor,
    cost_matrix: torch.Tensor,
    eval_temperature: float = 0.01,
    *,
    noise: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """Discrete parsimony score of trained parameters (one per restart):
    discretise at ``eval_temperature``, reorder the nodes by their learned
    parents (``order = argmax(hard_tree)``, the reference's recipe) and
    score with ``exact_cost``."""
    soft_tree, hard_tree, soft_seqs = extract_solution(
        params, leaf_tensor, eval_temperature, noise=noise, generator=generator)
    q = leaf_tensor.shape[-1]
    hard_seqs = torch.nn.functional.one_hot(soft_seqs.argmax(-1), q).to(torch.float32)
    order = hard_tree.argmax(-1)
    tree = torch.take_along_dim(soft_tree, order[..., :, None], dim=-2)
    tree = torch.take_along_dim(tree, order[..., None, :], dim=-1)
    seqs = torch.take_along_dim(hard_seqs, order[..., :, None, None], dim=-3)
    return exact_cost(seqs, tree, cost_matrix)


def _restart_rows(mesh, n_restarts: int) -> slice:
    """This rank's block of the restarts: the restart axis over the mesh's
    'tree' axis, which must divide it (all of them without a mesh)."""
    from trex_tpu_torch.parallel.mesh import TREE_AXIS

    if mesh is None:
        return slice(0, n_restarts)
    n_tree = mesh.shape[TREE_AXIS]
    if n_restarts % n_tree != 0:
        raise ValueError(
            f"n_restarts = {n_restarts} must be divisible by the mesh tree "
            f"axis size ({n_tree})"
        )
    size = n_restarts // n_tree
    return slice(mesh.tree_index * size, (mesh.tree_index + 1) * size)


def _mesh_draws(mesh, n_restarts: int, shape, generator, device, noise, eval_noise):
    """(rows, noise, eval_noise()) of this rank's restarts: the given draws'
    rows, or for draws from ``generator`` the whole batch's drawn on every
    rank in the single-device order (a step's noise at that step, the
    evaluation's after the descent) and the rank's rows taken."""
    rows = _restart_rows(mesh, n_restarts)
    full = (n_restarts, *shape)
    if noise is None:
        def noise(i):
            return gumbel(full, generator=generator, device=device)[rows]
    else:
        noise = noise[:, rows]

    def eval_draw():
        drawn = gumbel(full, generator=generator, device=device) if eval_noise is None \
            else eval_noise
        return drawn[rows]

    return rows, noise, eval_draw


def _best_over_mesh(mesh, rows: slice, params, losses, scores):
    """(params, losses, score) of the restart with the lowest score in the
    whole batch (the first on ties, as ``argmin``): one ``all_gather`` of
    each rank's (best score, its restart index) over 'tree', then the
    winner's params, losses and score broadcast from its rank (no
    collective without a mesh)."""
    from trex_tpu_torch.parallel.mesh import TREE_AXIS, local_mesh

    mesh = mesh or local_mesh()
    local = int(torch.argmin(scores))
    pair = torch.tensor([float(scores[local]), float(rows.start + local)],
                        dtype=torch.float64, device=scores.device)
    winner = int(torch.argmin(mesh.all_gather(pair, TREE_AXIS)[:, 0]))
    best = [*(v[local].clone() for v in params.values()), losses[:, local].clone(),
            scores[local].clone()]
    for t in best:
        mesh.broadcast(t, TREE_AXIS, winner)
    return dict(zip(params, best[:-2])), best[-2], best[-1]


def joint_search(
    leaf_tensor: torch.Tensor,
    cost_matrix: torch.Tensor,
    cfg: JointConfig = JointConfig(),
    n_restarts: int = 8,
    *,
    generator: torch.Generator | None = None,
    init: dict[str, torch.Tensor] | None = None,
    noise: torch.Tensor | None = None,
    eval_noise: torch.Tensor | None = None,
    mesh=None,
):
    """Multi-restart joint search; restarts are the leading axis.

    ``init`` (restart-stacked ``init_params``), ``noise`` ((n_iterations,
    R, n_all - 1, n_anc)) and ``eval_noise`` ((R, n_all - 1, n_anc)) are
    drawn from ``generator`` where not given. Returns (params, losses,
    score) of the restart whose discretised solution has the lowest exact
    parsimony cost (the first on ties).

    ``mesh``: an optional ``parallel.mesh.Mesh`` (every rank calls with the
    same arguments; None: this device alone): the restarts split over its
    'tree' axis, which must divide ``n_restarts``; each rank descends its
    block and the best restart comes back to every rank
    (``_best_over_mesh``). Draws from ``generator`` are the whole batch's,
    so the result is the single-device one.
    """
    n_leaves = (leaf_tensor.shape[0] + 1) // 2
    if init is None:
        init = init_params(n_leaves, leaf_tensor.shape[1], leaf_tensor.shape[2],
                           generator=generator, batch=(n_restarts,), device=leaf_tensor.device)
    rows, noise, eval_noise = _mesh_draws(mesh, n_restarts, init["tree_params"].shape[1:],
                                          generator, leaf_tensor.device, noise, eval_noise)
    params, losses = joint_optimize({k: v[rows] for k, v in init.items()}, leaf_tensor, cfg,
                                    noise=noise)
    scores = evaluate_solution(params, leaf_tensor, cost_matrix, noise=eval_noise())
    return _best_over_mesh(mesh, rows, params, losses, scores)


def fit_topology(
    sequences_one_hot: torch.Tensor,
    n_iterations: int = 3000,
    learning_rate: float = 0.05,
    constraint_scale: float = 10.0,
    n_restarts: int = 8,
    *,
    generator: torch.Generator | None = None,
    init: torch.Tensor | None = None,
    noise: torch.Tensor | None = None,
    eval_noise: torch.Tensor | None = None,
    mesh=None,
):
    """Learn only the topology for known (hard) sequences (the reference's
    "fixed sequences, learned topology" regime): Adam without clipping, the
    constraint penalty not temperature-scaled, ``n_restarts`` descents as
    one batch, and the restart with the best exact cost at temperature
    0.01 wins. ``init`` ((R, n_all - 1, n_anc) logits), ``noise``,
    ``eval_noise`` and ``mesh`` as in ``joint_search``. Returns (params,
    losses)."""
    n_all = sequences_one_hot.shape[0]
    n_anc = n_all - (n_all + 1) // 2
    device = sequences_one_hot.device
    if init is None:
        init = torch.randn((n_restarts, n_all - 1, n_anc), generator=generator, device=device)
    # A constant temperature of 1: the penalty enters unscaled.
    cfg = JointConfig(n_iterations=n_iterations, learning_rate=learning_rate,
                      temp_start=1.0, temp_end=1.0, constraint_scale=constraint_scale,
                      learn_sequences=False)
    rows, noise, eval_noise = _mesh_draws(mesh, n_restarts, init.shape[1:], generator,
                                          device, noise, eval_noise)
    params, losses = joint_optimize({"tree_params": init[rows]}, sequences_one_hot, cfg,
                                    fixed_sequences=sequences_one_hot, noise=noise)
    tree = soft_topology(params["tree_params"], 0.01, noise=eval_noise())
    q = sequences_one_hot.shape[-1]
    hamming = torch.ones((q, q), device=device) - torch.eye(q, device=device)
    scores = exact_cost(sequences_one_hot, tree, hamming)
    params, losses, _ = _best_over_mesh(mesh, rows, params, losses, scores)
    return params, losses
