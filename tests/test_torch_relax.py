"""Parity of the port's differentiable layer (``trex_tpu_torch.ops.costs``,
``ops.relax``, ``ops.soft_dp``) with trex_tpu's.

Inputs are made with numpy from a seed; the JAX package's Gumbel noise is
drawn from its keys as its functions draw it and handed to the port. Values
agree within rtol 1e-5 and ``torch.autograd`` gradients within rtol 1e-4 of
``jax.grad`` (float32 sums in another order); ``exact_cost``, the
projection and the straight-through estimator exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import parents_of, random_children

from trex_tpu.ops import costs as jax_costs
from trex_tpu.ops import relax as jax_relax
from trex_tpu.ops import soft_dp as jax_soft_dp
from trex_tpu.topology import Topology as JaxTopology
from trex_tpu_torch.ops import costs, relax, soft_dp
from trex_tpu_torch.topology import from_numpy

RTOL, GRAD_RTOL = 1e-5, 1e-4


def _close(got, want, rtol=RTOL, atol=1e-6):
    np.testing.assert_allclose(
        got.detach().numpy() if isinstance(got, torch.Tensor) else got,
        np.asarray(want), rtol=rtol, atol=atol)


def _soft_inputs(seed, n_leaves=6, length=10, q=4, batch=()):
    """Peaked soft sequences (a softmax of 3 x normal logits, so the costs
    do not cancel to near 0), a row-stochastic adjacency and a random
    (Q, Q) cost."""
    rng = np.random.default_rng(seed)
    n_all = 2 * n_leaves - 1
    seqs = np.exp(3 * rng.normal(size=(*batch, n_all, length, q))).astype(np.float32)
    seqs /= seqs.sum(-1, keepdims=True)
    adj = rng.random((*batch, n_all, n_all)).astype(np.float32)
    adj /= adj.sum(-1, keepdims=True)
    return seqs, adj, rng.random((q, q)).astype(np.float32)


def _check_value_and_grads(fn_jax, fn_torch, *arrays):
    """Holds a scalar torch function of ``arrays`` and its autograd
    gradients to the JAX function's value and ``jax.grad`` (one jitted
    call); a gradient that autograd leaves as None (an input off the
    loss's path) must be 0 in JAX."""
    value, want = jax.jit(jax.value_and_grad(fn_jax, argnums=tuple(range(len(arrays)))))(
        *map(jnp.asarray, arrays))
    tensors = [torch.tensor(a, requires_grad=True) for a in arrays]
    got = fn_torch(*tensors)
    _close(got, value)
    got.backward()
    for t, w in zip(tensors, want):
        if t.grad is None:
            assert not np.asarray(w).any()
        else:
            _close(t.grad, w, rtol=GRAD_RTOL, atol=1e-5)


@pytest.mark.parametrize("weighting", ["surrogate", "none", "diagonal", "matrix"])
def test_soft_costs_values_and_gradients(weighting):
    seqs, adj, cost = _soft_inputs(0)
    weight = {"none": None, "diagonal": cost[0], "matrix": cost}.get(weighting)

    def jax_fn(s, a):
        if weighting == "surrogate":
            return jax_costs.surrogate_cost(s, a)
        return jax_costs.soft_parsimony_cost(s, a, None if weight is None else jnp.asarray(weight))

    def torch_fn(s, a):
        if weighting == "surrogate":
            return costs.surrogate_cost(s, a)
        return costs.soft_parsimony_cost(s, a, None if weight is None else torch.tensor(weight))

    _check_value_and_grads(jax_fn, torch_fn, seqs, adj)


def test_costs_take_a_restart_axis():
    """(R, N, L, Q) sequences and (R, N, N) adjacencies give R costs, each
    the unbatched cost of its restart."""
    seqs, adj, cost = _soft_inputs(1, batch=(3,))
    cost = np.round(3 * cost)  # integer costs: exact_cost's sums are exact
    s, a = torch.tensor(seqs), torch.tensor(adj)
    batched = costs.surrogate_cost(s, a)
    weighted = costs.soft_parsimony_cost(s, a, torch.tensor(cost))
    exact = costs.exact_cost(s, a, torch.tensor(cost))
    assert batched.shape == weighted.shape == exact.shape == (3,)
    per_restart = jax.jit(jax.vmap(lambda s, a: (
        jax_costs.surrogate_cost(s, a), jax_costs.soft_parsimony_cost(s, a, cost),
        jax_costs.exact_cost(s, a, jnp.asarray(cost)))))(seqs, adj)
    _close(batched, per_restart[0])
    _close(weighted, per_restart[1])
    np.testing.assert_array_equal(exact.numpy(), np.asarray(per_restart[2]))


def test_exact_cost_is_exact():
    rng = np.random.default_rng(2)
    seqs, adj, _ = _soft_inputs(3)
    cost = rng.integers(0, 4, (4, 4)).astype(np.float32)
    got = costs.exact_cost(torch.tensor(seqs), torch.tensor(adj), torch.tensor(cost))
    assert float(got) == float(jax_costs.exact_cost(seqs, adj, cost))


def _jax_tree_logits(seed, n_leaves):
    n_all = 2 * n_leaves - 1
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n_all - 1, n_leaves - 1)).astype(np.float32)


@pytest.mark.parametrize("n_leaves", [2, 8])
@pytest.mark.parametrize("gated", [False, True])
def test_soft_topology_same_noise(n_leaves, gated):
    logits = _jax_tree_logits(n_leaves, n_leaves)
    key = jax.random.PRNGKey(n_leaves)
    noise = np.asarray(jax.random.gumbel(key, logits.shape))
    gates = np.random.default_rng(7).random(logits.shape).astype(np.float32) if gated else None

    def jax_fn(x):
        return jax_relax.soft_topology(key, x, 0.7, None if gates is None else jnp.asarray(gates))

    def torch_fn(x):
        return relax.soft_topology(
            x, 0.7, None if gates is None else torch.tensor(gates), noise=torch.tensor(noise))

    weights = np.random.default_rng(8).random((2 * n_leaves - 1,) * 2).astype(np.float32)
    want, want_grad = jax.jit(lambda x: (
        jax_fn(x), jax.grad(lambda y: jnp.sum(jax_fn(y) * weights))(x)))(logits)
    x = torch.tensor(logits, requires_grad=True)
    got = torch_fn(x)
    _close(got, want)
    (got * torch.tensor(weights)).sum().backward()
    _close(x.grad, want_grad, rtol=GRAD_RTOL, atol=1e-6)


def test_gumbel_draws_are_finite_and_standard():
    """The port's own noise: finite where U would be 0, Gumbel moments."""
    draws = relax.gumbel((200_000,), generator=torch.Generator().manual_seed(0))
    assert bool(torch.isfinite(draws).all())
    assert abs(float(draws.mean()) - 0.5772) < 0.01
    assert abs(float(draws.var()) - np.pi ** 2 / 6) < 0.03
    tiny = torch.finfo(torch.float32).tiny
    assert np.isfinite(float(-np.log(-np.log(np.float32(tiny)))))


def test_soft_sequences_and_discretize():
    rng = np.random.default_rng(4)
    n_leaves, length, q = 5, 7, 4
    seqs = rng.random((2 * n_leaves - 1, length, q)).astype(np.float32)
    logits = rng.normal(size=(n_leaves - 1, length, q)).astype(np.float32)
    got = relax.soft_sequences(torch.tensor(logits), torch.tensor(seqs), n_leaves, 1.7)
    _close(got, jax_relax.soft_sequences(jnp.asarray(logits), jnp.asarray(seqs), n_leaves, 1.7))
    adj = rng.random((9, 9)).astype(np.float32)
    adj[3, 2] = adj[3, 5] = adj[3].max() + 1.0  # a tie: the first index wins
    np.testing.assert_array_equal(relax.discretize_topology(torch.tensor(adj)).numpy(),
                                  np.asarray(jax_relax.discretize_topology(adj)))


def _jax_project(adj):
    topo = jax.vmap(jax_relax.project_topology)(jnp.asarray(adj))
    return np.asarray(topo.children), np.asarray(topo.parents)


@pytest.mark.parametrize("n_leaves", [3, 16])
def test_project_topology_same_trees(n_leaves):
    """Identical soft adjacencies project to the same children and parents,
    restarts projected together: Gumbel-softmax ones at T = 1 and T = 0.05,
    and a one-hot one with exact ties."""
    n_all = 2 * n_leaves - 1
    rng = np.random.default_rng(n_leaves)
    logits = rng.normal(size=(4, n_all - 1, n_leaves - 1)).astype(np.float32)
    noise = rng.gumbel(size=logits.shape).astype(np.float32)
    adj = np.concatenate([
        relax.soft_topology(torch.tensor(logits[:2]), 1.0, noise=torch.tensor(noise[:2])).numpy(),
        relax.soft_topology(torch.tensor(logits[2:]), 0.05, noise=torch.tensor(noise[2:])).numpy(),
        np.eye(n_all, dtype=np.float32)[None],
    ])
    topo = relax.project_topology(torch.tensor(adj))
    children, parents = _jax_project(adj)
    np.testing.assert_array_equal(topo.children.numpy(), children)
    np.testing.assert_array_equal(topo.parents.numpy(), parents)


def test_penalty_and_joint_loss():
    n_leaves, length, q = 6, 9, 4
    n_all = 2 * n_leaves - 1
    rng = np.random.default_rng(5)
    params = {"tree_params": rng.normal(size=(n_all - 1, n_leaves - 1)).astype(np.float32),
              "ancestors": rng.normal(size=(n_leaves - 1, length, q)).astype(np.float32)}
    seqs = np.zeros((n_all, length, q), np.float32)
    seqs[np.arange(n_leaves)[:, None], np.arange(length), rng.integers(0, q, (n_leaves, length))] = 1
    _, adj, _ = _soft_inputs(6)
    _close(relax.binary_tree_penalty(torch.tensor(adj), 3.0),
           jax_relax.binary_tree_penalty(adj, 3.0))
    key = jax.random.PRNGKey(9)
    noise = np.asarray(jax.random.gumbel(jax.random.split(key)[1], params["tree_params"].shape))
    for fix_seqs, fix_tree in ((False, False), (True, False), (False, True)):
        def jax_fn(tree, anc):
            return jax_relax.joint_loss(key, {"tree_params": tree, "ancestors": anc},
                                        jnp.asarray(seqs), 0.8, jnp.asarray(adj),
                                        fix_seqs=fix_seqs, fix_tree=fix_tree)

        def torch_fn(tree, anc):
            return relax.joint_loss({"tree_params": tree, "ancestors": anc}, torch.tensor(seqs),
                                    0.8, torch.tensor(adj), noise=torch.tensor(noise),
                                    fix_seqs=fix_seqs, fix_tree=fix_tree)

        _check_value_and_grads(jax_fn, torch_fn, params["tree_params"], params["ancestors"])


def test_straight_through_forward_and_backward():
    rng = np.random.default_rng(10)
    x = rng.random((3, 5, 4)).astype(np.float32)
    x[0, 0, 1] = x[0, 0, 3] = 2.0  # a tie: the first index wins
    cot = rng.random((3, 5)).astype(np.float32)
    y, vjp = jax.vjp(jax_relax.straight_through, jnp.asarray(x))
    (want,) = vjp(jnp.asarray(cot))
    xt = torch.tensor(x, requires_grad=True)
    yt = relax.straight_through(xt)
    np.testing.assert_array_equal(yt.detach().long().numpy(), np.asarray(y))
    (got,) = torch.autograd.grad(yt, xt, torch.tensor(cot))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _dp_case(seed, n_leaves=7, q=4, length=12):
    rng = np.random.default_rng(seed)
    children = random_children(rng, n_leaves, 3)
    leaves = rng.integers(0, q, (n_leaves, length)).astype(np.int32)
    cost = (rng.random((q, q)) * 2).astype(np.float32)
    np.fill_diagonal(cost, 0.0)
    leaf_costs = (rng.random((n_leaves, q, length)) * 3).astype(np.float32)
    mask = (rng.random(length) < 0.8).astype(np.float32)
    return children, parents_of(children), leaves, cost, leaf_costs, mask


@pytest.mark.parametrize("temperature", [0.05, 0.5])
def test_soft_sankoff_value_and_gradients(temperature):
    """Value and gradients in the cost, the leaf costs and T, with a site mask."""
    children, parents, _, cost, leaf_costs, mask = _dp_case(11)
    jtopo = JaxTopology(jnp.asarray(children[0]), jnp.asarray(parents[0]))
    ttopo = from_numpy(children[0], parents[0])

    def jax_fn(c, leaf, t):
        return jax_soft_dp.soft_sankoff_score(jtopo, c, leaf, t, jnp.asarray(mask))

    def torch_fn(c, leaf, t):
        return soft_dp.soft_sankoff_score(ttopo, c, leaf, t, torch.tensor(mask))

    _check_value_and_grads(jax_fn, torch_fn, cost, leaf_costs, np.float32(temperature))


def test_soft_sankoff_from_sequences_batched():
    children, parents, leaves, cost, _, _ = _dp_case(12)
    jtopos = JaxTopology(jnp.asarray(children), jnp.asarray(parents))
    want = jax.jit(jax_soft_dp.batched_soft_sankoff_score)(jtopos, cost, leaves, 0.2)
    got = soft_dp.batched_soft_sankoff_score(
        from_numpy(children, parents), torch.tensor(cost), torch.tensor(leaves), 0.2)
    _close(got, want)
    x = np.array([[3.0, 1.0, 2.0]], np.float32)
    _close(soft_dp.softmin(torch.tensor(x), 1, 0.3), jax_soft_dp.softmin(x, 1, 0.3))


def test_padding_matches_jax():
    """Buckets, padding, masks and masked reductions (``padding.py``)."""
    from trex_tpu import padding as jax_padding
    from trex_tpu_torch import padding

    for value in (1, 33, 128, 129, 20000, 40000):
        assert padding.site_bucket(value) == jax_padding.site_bucket(value)
        assert padding.node_bucket(value) == jax_padding.node_bucket(value)
    assert padding.k_bucket(3) == jax_padding.k_bucket(3) == 4
    rng = np.random.default_rng(13)
    tables = rng.random((5, 8)).astype(np.float32)
    inter = rng.integers(0, 5, (5, 2)).astype(np.int32)
    got = padding.pad_nk_tables(torch.tensor(tables), torch.tensor(inter), 8, 4, 2)
    want = jax_padding.pad_nk_tables(jnp.asarray(tables), jnp.asarray(inter), 8, 4, 2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    seqs = rng.integers(0, 4, (3, 10)).astype(np.int32)
    np.testing.assert_array_equal(padding.pad_sites(torch.tensor(seqs), 16).numpy(),
                                  np.asarray(jax_padding.pad_sites(jnp.asarray(seqs), 16)))
    adj = rng.random((5, 5)).astype(np.float32)
    np.testing.assert_array_equal(padding.pad_adjacency(torch.tensor(adj), 7).numpy(),
                                  np.asarray(jax_padding.pad_adjacency(jnp.asarray(adj), 7)))
    mask = padding.site_mask(10, 16)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jax_padding.site_mask(10, 16)))
    np.testing.assert_array_equal(padding.node_mask(3, 7).numpy(),
                                  np.asarray(jax_padding.node_mask(3, 7)))
    values = rng.random(16).astype(np.float32)
    _close(padding.masked_sum(torch.tensor(values), mask),
           jax_padding.masked_sum(jnp.asarray(values), jnp.asarray(mask.numpy())))
    _close(padding.masked_mean(torch.tensor(values), mask),
           jax_padding.masked_mean(jnp.asarray(values), jnp.asarray(mask.numpy())))
    with pytest.raises(ValueError):
        padding.pad_axis(torch.zeros(5), 0, 3)
