"""The sharded joint steps and the restart-sharded searches on two CPU ranks
(gloo), on the (2, 1) and (1, 2) meshes of one world, against the JAX
package's single-device step (set up as ``tests/test_sharding.py``'s: Adam
at 0.01, no clip, temperature 1, the step key's Gumbel noise) within rtol
1e-5, and ``joint_search`` / ``fit_topology`` with the restarts over 'tree'
against the JAX functions under their draws (each restart's initial
parameters, step noise and evaluation noise from its keys)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from _torch_dist import MESHES, start_ranks

from trex_tpu.ops.costs import surrogate_cost
from trex_tpu.ops.relax import binary_tree_penalty, soft_sequences, soft_topology
from trex_tpu.search import joint as jax_joint
from trex_tpu.search.optimizers import make_optimizer
from trex_tpu.types import CostModel

N_LEAVES, LENGTH, Q, RESTARTS, STEPS = 5, 32, 4, 4, 30
N_ALL = 2 * N_LEAVES - 1
TREE_SHAPE = (N_ALL - 1, N_LEAVES - 1)


def _one_hot(rng, rows):
    leaf = np.zeros((N_ALL, LENGTH, Q), np.float32)
    states = rng.integers(0, Q, (rows, LENGTH))
    leaf[np.arange(rows)[:, None], np.arange(LENGTH), states] = 1.0
    return leaf


def _loss(p, leaf, key):
    seqs = soft_sequences(p["ancestors"], leaf, N_LEAVES, 1.0)
    tree = soft_topology(key, p["tree_params"])
    return surrogate_cost(seqs, tree) + 1.0 * binary_tree_penalty(tree, 10.0)


def _restart_draws(key):
    """Each restart's (init, step noise, evaluation noise), as
    ``joint_search`` draws them from its key (one jitted map over the
    restart keys)."""
    def one(restart_key):
        k_init, k_run, k_eval = jax.random.split(restart_key, 3)
        return (jax_joint.init_params(k_init, N_LEAVES, LENGTH, Q),
                jax.vmap(lambda k: jax.random.gumbel(k, TREE_SHAPE))(
                    jax.random.split(k_run, STEPS)),
                jax.random.gumbel(k_eval, TREE_SHAPE))

    init, noise, evals = jax.jit(jax.vmap(one))(jax.random.split(key, RESTARTS))
    return ({k: np.asarray(v) for k, v in init.items()}, np.asarray(noise).swapaxes(0, 1),
            np.asarray(evals))


def _fit_draws(key):
    """``fit_topology``'s draws: each restart's tree logits, step noise and
    evaluation noise."""
    def one(restart_key):
        k_tree, k_run, k_eval = jax.random.split(restart_key, 3)
        return (jax.random.normal(k_tree, TREE_SHAPE),
                jax.vmap(lambda k: jax.random.gumbel(k, TREE_SHAPE))(
                    jax.random.split(k_run, STEPS)),
                jax.random.gumbel(k_eval, TREE_SHAPE))

    init, noise, evals = jax.jit(jax.vmap(one))(jax.random.split(key, RESTARTS))
    return np.asarray(init), np.asarray(noise).swapaxes(0, 1), np.asarray(evals)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    rng = np.random.default_rng(4)
    leaf = _one_hot(rng, N_LEAVES)
    params = {"tree_params": rng.normal(size=TREE_SHAPE).astype(np.float32),
              "ancestors": rng.normal(size=(N_LEAVES - 1, LENGTH, Q)).astype(np.float32)}
    r_params = {"tree_params": rng.normal(size=(RESTARTS, *TREE_SHAPE)).astype(np.float32),
                "ancestors": rng.normal(size=(RESTARTS, N_LEAVES - 1, LENGTH, Q)).astype(
                    np.float32)}
    step_key = jax.random.PRNGKey(9)
    step_keys = jax.random.split(jax.random.PRNGKey(10), RESTARTS)
    gumbel = jax.jit(jax.vmap(lambda k: jax.random.gumbel(k, TREE_SHAPE)))
    s_init, s_noise, s_eval = _restart_draws(jax.random.PRNGKey(11))
    f_seqs = _one_hot(np.random.default_rng(5), N_ALL)
    f_init, f_noise, f_eval = _fit_draws(jax.random.PRNGKey(12))
    inputs = dict(
        leaf=leaf, tree_params=params["tree_params"], ancestors=params["ancestors"],
        noise=np.asarray(gumbel(step_key[None]))[0],
        r_tree_params=r_params["tree_params"], r_ancestors=r_params["ancestors"],
        r_noise=np.asarray(gumbel(step_keys)),
        cost=np.asarray(CostModel.hamming(Q).matrix), n_iterations=np.array(STEPS),
        s_tree=s_init["tree_params"], s_anc=s_init["ancestors"], s_noise=s_noise,
        s_eval=s_eval, f_seqs=f_seqs, f_tree=f_init, f_noise=f_noise, f_eval=f_eval)
    ranks = start_ranks(tmp_path_factory.mktemp("joint"), "joint", inputs)

    optimizer = make_optimizer("adam", 0.01, clip_global_norm=None)
    jleaf = jnp.asarray(leaf)

    @jax.jit
    def step(p):
        loss, grads = jax.value_and_grad(_loss)(p, jleaf, step_key)
        updates, _ = optimizer.update(grads, optimizer.init(p), p)
        return loss, optax.apply_updates(p, updates)

    @jax.jit
    def restart_step(p):
        def batched(q):
            losses = jax.vmap(lambda r, k: _loss(r, jleaf, k))(q, step_keys)
            return jnp.sum(losses), losses

        grads, losses = jax.grad(batched, has_aux=True)(p)
        updates, _ = optimizer.update(grads, optimizer.init(p), p)
        return losses, optax.apply_updates(p, updates)

    want = {"step": step(params), "rstep": restart_step(r_params)}
    cfg = jax_joint.JointConfig(n_iterations=STEPS)
    want["search"] = jax_joint.joint_search(jax.random.PRNGKey(11), jleaf,
                                            CostModel.hamming(Q).matrix, cfg,
                                            n_restarts=RESTARTS)
    want["fit"] = jax_joint.fit_topology(jax.random.PRNGKey(12), jnp.asarray(f_seqs),
                                         n_iterations=STEPS, n_restarts=RESTARTS)
    return want, ranks.wait()


@pytest.mark.parametrize("mesh", MESHES)
def test_sharded_joint_step_equals_single_device(case, mesh):
    want, outs = case
    loss, params = want["step"]
    for out in outs:
        assert float(out[f"{mesh}_step_loss"]) == pytest.approx(float(loss), rel=1e-5)
        np.testing.assert_allclose(out[f"{mesh}_step_tree"], params["tree_params"], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(out[f"{mesh}_step_anc"], params["ancestors"], rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("mesh", MESHES)
def test_sharded_restart_step_equals_single_device(case, mesh):
    want, outs = case
    losses, params = want["rstep"]
    for out in outs:
        np.testing.assert_allclose(out[f"{mesh}_rstep_loss"], losses, rtol=1e-5)
        np.testing.assert_allclose(out[f"{mesh}_rstep_tree"], params["tree_params"],
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(out[f"{mesh}_rstep_anc"], params["ancestors"], rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("mesh", MESHES)
def test_restart_sharded_searches_return_jax_best(case, mesh):
    want, outs = case
    params, losses, score = want["search"]
    fit_params, fit_losses = want["fit"]
    for out in outs:
        assert float(out[f"{mesh}_search_score"]) == float(score)
        np.testing.assert_allclose(out[f"{mesh}_search_losses"], np.asarray(losses), rtol=1e-4)
        for k in ("tree_params", "ancestors"):
            np.testing.assert_allclose(out[f"{mesh}_search_{k}"], np.asarray(params[k]),
                                       atol=1e-4)
        np.testing.assert_allclose(out[f"{mesh}_fit_losses"], np.asarray(fit_losses), rtol=1e-4)
        np.testing.assert_allclose(out[f"{mesh}_fit_tree"], np.asarray(fit_params["tree_params"]),
                                   atol=1e-4)


def test_restarts_must_divide_the_tree_axis():
    import torch

    from trex_tpu_torch.parallel import make_mesh
    from trex_tpu_torch.search.joint import JointConfig, joint_search

    mesh = make_mesh(world_size=2, tree_parallelism=2)
    with pytest.raises(ValueError, match="n_restarts = 3 must be divisible by the mesh tree"):
        joint_search(torch.zeros((N_ALL, LENGTH, Q)), torch.ones((Q, Q)),
                     JointConfig(n_iterations=2), n_restarts=3, mesh=mesh,
                     generator=torch.Generator().manual_seed(0))
