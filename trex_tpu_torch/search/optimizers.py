"""Optimizer factory (counterpart of ``trex_tpu/search/optimizers.py``).

Same names and numbers as the JAX package's optax 0.2.6 optimizers:

- ``adam`` (b1 0.9, b2 0.999, eps 1e-8), ``sgd`` (momentum 0.9) and
  ``adamw`` (weight decay 0.01, scaled by the learning rate) are
  ``torch.optim``'s, which follow optax formula for formula;
- ``rmsprop`` is optax's, not ``torch.optim.RMSprop``'s: decay 0.9 and eps
  inside the root, ``g * rsqrt(nu + eps)`` (``RMSprop`` below);
- clipping is optax's ``clip_by_global_norm``: gradients scaled by
  ``max / norm`` only where ``norm >= max`` (``clip_grad_norm_`` divides
  by ``norm + 1e-6`` everywhere). With ``batched=True`` the leading axis
  of every parameter is a restart axis and each restart is clipped by its
  own norm, as the JAX package clips inside ``vmap``.
"""

from __future__ import annotations

from typing import Iterable

import torch


class RMSprop(torch.optim.Optimizer):
    """optax's ``rmsprop``: ``nu = decay * nu + (1 - decay) * g^2`` (from 0),
    ``p -= lr * g * rsqrt(nu + eps)``."""

    def __init__(self, params, lr: float, decay: float = 0.9, eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, decay=decay, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None if closure is None else closure()
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["nu"] = torch.zeros_like(p)
                nu = state["nu"]
                nu.mul_(group["decay"]).add_((1 - group["decay"]) * p.grad.square())
                p.add_(-group["lr"] * (torch.rsqrt(nu + group["eps"]) * p.grad))
        return loss


_FACTORIES = {
    "adam": lambda params, lr: torch.optim.Adam(params, lr=lr),
    "sgd": lambda params, lr: torch.optim.SGD(params, lr=lr, momentum=0.9),
    "rmsprop": lambda params, lr: RMSprop(params, lr=lr),
    "adamw": lambda params, lr: torch.optim.AdamW(params, lr=lr, weight_decay=0.01),
}


@torch.no_grad()
def clip_by_global_norm_(
    params: Iterable[torch.Tensor], max_norm: float, *, batched: bool = False
) -> None:
    """optax's global-norm clip of the gradients of ``params``, in place:
    each gradient times ``max_norm / norm`` where ``norm >= max_norm``.
    With ``batched``, one norm per index of the leading axis."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    if batched:
        sq = sum(g.square().flatten(1).sum(1) for g in grads)
    else:
        sq = sum(g.square().sum() for g in grads)
    norm = sq.sqrt()
    for g in grads:
        n = norm.view(-1, *[1] * (g.dim() - 1)) if batched else norm
        g.copy_(torch.where(n < max_norm, g, g / n.to(g.dtype) * max_norm))


def make_optimizer(
    name: str,
    learning_rate: float,
    params: Iterable[torch.Tensor],
    *,
    clip_global_norm: float | None = 1.0,
    batched: bool = False,
) -> torch.optim.Optimizer:
    """A ``torch.optim.Optimizer`` over ``params`` by name, clipping each
    step's gradients to ``clip_global_norm`` first (None: no clip).

    Same names and hyperparameters as the JAX factory: sgd carries momentum
    0.9, adamw weight decay 0.01, and clipping defaults to norm 1.0.
    ``batched``: the leading axis of every parameter indexes restarts, and
    each restart is clipped by its own norm.
    """
    if name not in _FACTORIES:
        raise ValueError(f"Unknown optimizer {name!r}; choose from {sorted(_FACTORIES)}")
    params = list(params)
    optimizer = _FACTORIES[name](params, learning_rate)
    if clip_global_norm is not None:
        optimizer.register_step_pre_hook(
            lambda opt, args, kwargs: clip_by_global_norm_(
                params, clip_global_norm, batched=batched)
        )
    return optimizer
