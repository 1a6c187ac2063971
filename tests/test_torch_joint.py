"""Parity of the port's optimizers, joint search and checkpointed runner
(``trex_tpu_torch.search.optimizers``, ``search.joint``, ``search.runner``)
with trex_tpu's.

- The four optimizers, with and without the global-norm clip (per
  restart on a restart axis), follow optax over 20 steps of the same
  gradients within rtol 1e-5 (and atol 1e-5 on these O(1) parameters:
  optax computes Adam's bias corrections ``1 - b**t`` in float32,
  ``torch.optim`` in double, 1.3e-5 apart relative at the first step, so
  an element near 0 differs by a few 1e-6).
- ``joint_optimize`` from the JAX ``init_params`` (``params_from_numpy``)
  with the JAX steps' Gumbel noise: loss curve within rtol 1e-4, params
  within atol 1e-4 after 50 steps.
- The runner's resume is bit-identical to an uninterrupted run.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import _torch_parity  # noqa: F401  (one PyTorch thread per worker)

from trex_tpu.search import joint as jax_joint
from trex_tpu.search.optimizers import make_optimizer as jax_make_optimizer
from trex_tpu_torch.search import joint
from trex_tpu_torch.search.optimizers import make_optimizer
from trex_tpu_torch.search.runner import RunnerConfig, run_search

N_STEPS = 20


def _optimizer_case(seed, restarts):
    """Initial params and N_STEPS gradients whose per-restart norms straddle 1."""
    rng = np.random.default_rng(seed)
    shapes = {"a": (restarts, 3, 4), "b": (restarts, 5)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = {k: (rng.normal(size=(N_STEPS, *s)) * rng.uniform(0.05, 0.6, (N_STEPS, restarts)
             + (1,) * (len(s) - 1))).astype(np.float32) for k, s in shapes.items()}
    return params, grads


def _optax_run(name, clip, params, grads, batched):
    opt = jax_make_optimizer(name, 0.05, clip_global_norm=clip)

    def run(p, g):
        def step(carry, g_t):
            p, s = carry
            updates, s = opt.update(g_t, s, p)
            return (optax.apply_updates(p, updates), s), None
        (p, _), _ = jax.lax.scan(step, (p, opt.init(p)), g)
        return p

    if batched:
        return jax.jit(jax.vmap(run, in_axes=(0, 1)))(params, grads)
    return jax.jit(run)(params, grads)


OPTIMIZERS = ["adam", "sgd", "rmsprop", "adamw"]


@pytest.mark.parametrize("clip", [None, 1.0])
@pytest.mark.parametrize("name", OPTIMIZERS)
def test_optimizers_follow_optax(name, clip):
    """On a restart axis of 3: one optimizer over the stacked params, each
    restart clipped by its own global norm, against optax in ``vmap``."""
    params, grads = _optimizer_case(2 * OPTIMIZERS.index(name) + (clip is None), restarts=3)
    want = _optax_run(name, clip, params, grads, batched=True)
    tensors = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    opt = make_optimizer(name, 0.05, tensors.values(), clip_global_norm=clip, batched=True)
    for t in range(N_STEPS):
        for k, p in tensors.items():
            p.grad = torch.tensor(grads[k][t])
        opt.step()
    for k, p in tensors.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want[k]), rtol=1e-5, atol=1e-5)


def test_global_clip_over_all_params():
    """Without a restart axis the clip takes one norm over every tensor."""
    params, grads = _optimizer_case(5, restarts=1)
    grads = {k: g * 4 for k, g in grads.items()}
    want = _optax_run("adam", 1.0, params, grads, batched=False)
    tensors = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    opt = make_optimizer("adam", 0.05, tensors.values())
    for t in range(N_STEPS):
        for k, p in tensors.items():
            p.grad = torch.tensor(grads[k][t])
        opt.step()
    for k, p in tensors.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want[k]), rtol=1e-5, atol=1e-5)


def _leaf_tensor(seed, n_leaves, length, q):
    rng = np.random.default_rng(seed)
    leaf = np.zeros((2 * n_leaves - 1, length, q), np.float32)
    states = rng.integers(0, q, (n_leaves, length))
    leaf[np.arange(n_leaves)[:, None], np.arange(length), states] = 1.0
    return leaf


def _jax_step_noise(keys, shape):
    """(n_steps, ...) Gumbel noise of each step key, as ``joint_optimize``
    draws it."""
    return np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, shape))(keys))


def test_joint_optimize_follows_jax():
    """Two restarts of 50 annealed steps, then a frozen-topology AdamW run
    whose fixed tree logits still decay, as optax decays them."""
    n_leaves, length, q, steps = 6, 12, 4, 50
    n_all = 2 * n_leaves - 1
    leaf = _leaf_tensor(0, n_leaves, length, q)
    cfg = jax_joint.JointConfig(n_iterations=steps)
    init_keys = jax.random.split(jax.random.PRNGKey(3), 2)
    run_keys = jax.random.split(jax.random.PRNGKey(4), 2)
    init = jax.vmap(lambda k: jax_joint.init_params(k, n_leaves, length, q))(init_keys)
    runs = [jax_joint.joint_optimize(k, {n: v[r] for n, v in init.items()}, jnp.asarray(leaf), cfg)
            for r, k in enumerate(run_keys)]
    noise = np.stack([_jax_step_noise(jax.random.split(k, steps), (n_all - 1, n_leaves - 1))
                      for k in run_keys], axis=1)
    got, losses = joint.joint_optimize(
        joint.params_from_numpy(init), torch.tensor(leaf), joint.JointConfig(n_iterations=steps),
        noise=torch.tensor(noise))
    for r, (want, want_losses) in enumerate(runs):
        np.testing.assert_allclose(losses[:, r].numpy(), np.asarray(want_losses), rtol=1e-4)
        for k in got:
            np.testing.assert_allclose(got[k][r].numpy(), np.asarray(want[k]), atol=1e-4)

    frozen = jax_joint.JointConfig(n_iterations=steps, optimizer="adamw", learn_topology=False,
                                   clip_global_norm=1.0)
    fixed = np.eye(n_all, dtype=np.float32)[np.r_[n_leaves + np.arange(n_all - 1) // 2, 0]]
    params = {k: v[0] for k, v in init.items()}
    want, want_losses = jax_joint.joint_optimize(
        run_keys[0], params, jnp.asarray(leaf), frozen, fixed_adjacency=jnp.asarray(fixed))
    got, losses = joint.joint_optimize(
        joint.params_from_numpy(params), torch.tensor(leaf),
        joint.JointConfig(**{f: getattr(frozen, f) for f in frozen.__dataclass_fields__}),
        fixed_adjacency=torch.tensor(fixed))
    np.testing.assert_allclose(losses.numpy(), np.asarray(want_losses), rtol=1e-4)
    assert not np.allclose(np.asarray(want["tree_params"]), params["tree_params"])
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-4)


def test_runner_resume_bit_identical(tmp_path):
    """Two segments of 50, then a resumed call to the end, equal an
    uninterrupted run bit for bit; metrics and checkpoints are written."""
    leaf = torch.tensor(_leaf_tensor(1, 4, 16, 4))
    cfg = joint.JointConfig(n_iterations=200, learning_rate=0.02)
    a = run_search(RunnerConfig(str(tmp_path / "a"), 200, 200, seed=7, joint=cfg), leaf)
    cfg_b = RunnerConfig(str(tmp_path / "b"), 200, 50, seed=7, joint=cfg)
    run_search(cfg_b, leaf, max_segments=2)
    assert sorted(os.listdir(tmp_path / "b" / "checkpoints")) == ["step_100", "step_50"]
    b = run_search(cfg_b, leaf, resume=True)
    for k in ("tree_params", "ancestors"):
        assert torch.equal(a[k], b[k])
    lines = [json.loads(line) for line in open(tmp_path / "b" / "metrics.jsonl")]
    assert [line["step"] for line in lines] == [50, 100, 150, 200]
    assert os.path.isdir(tmp_path / "b" / "checkpoints" / "step_200")
