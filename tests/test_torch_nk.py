"""Parity of the port's NK model and gradient ASR (``trex_tpu_torch.models.nk``,
``search.asr``) with trex_tpu's.

The JAX landscape, its initial ASR logits and its MH walks' draws (split
from the keys exactly as ``evolve_tree`` and ``reconstruct_ancestors``
split them) are handed to the port as arrays. Fitness and logits agree
within rtol 1e-5, the landscape-aware loss and its gradient within 1e-5 and
1e-4, the evolved sequences exactly. After 200 Adam steps of ASR the
logits agree within atol 1e-4, and the argmax ancestors wherever JAX's top
two logits differ by more than 1e-3 (closer ones may swap on float32
rounding).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _torch_parity  # noqa: F401  (one PyTorch thread per worker)

from trex_tpu.models import nk as jax_nk
from trex_tpu.ops.costs import surrogate_cost as jax_surrogate
from trex_tpu.ops.relax import soft_sequences as jax_soft_sequences
from trex_tpu.search import asr as jax_asr
from trex_tpu.search.optimizers import make_optimizer as jax_make_optimizer
from trex_tpu.topology import balanced_topology as jax_balanced
from trex_tpu.topology import topology_to_adjacency as jax_adjacency
from trex_tpu_torch.models import nk
from trex_tpu_torch.ops.costs import surrogate_cost
from trex_tpu_torch.ops.relax import soft_sequences
from trex_tpu_torch.search import asr
from trex_tpu_torch.topology import balanced_topology

N_LEAVES, LENGTH = 8, 24


@functools.lru_cache(maxsize=None)
def _landscapes(k, n_states=2, length=LENGTH):
    jl = jax.jit(jax_nk.make_landscape, static_argnums=(0, 1, 3))(
        length, k, jax.random.PRNGKey(k), n_states)
    tl = nk.landscape_from_numpy(np.asarray(jl.interactions), np.asarray(jl.tables), n_states, k)
    return jl, tl


@pytest.mark.parametrize("k", [0, 1, 3])
def test_sequence_fitness(k):
    jl, tl = _landscapes(k)
    rng = np.random.default_rng(k)
    seqs = rng.integers(0, 2, (5, LENGTH)).astype(np.int32)
    mask = rng.random(LENGTH) < 0.7
    want, want_masked = jax.jit(lambda s, m: (
        jax_nk.batched_sequence_fitness(s, jl), jax_nk.sequence_fitness(s[0], jl, m)))(seqs, mask)
    np.testing.assert_allclose(nk.batched_sequence_fitness(torch.tensor(seqs), tl).numpy(),
                               np.asarray(want), rtol=1e-5)
    got = nk.sequence_fitness(torch.tensor(seqs[0]), tl, torch.tensor(mask))
    np.testing.assert_allclose(float(got), float(want_masked), rtol=1e-5)


@pytest.mark.parametrize("k", [0, 1, 3])
@pytest.mark.parametrize("site_chunk", [None, 5])
def test_parental_logits(k, site_chunk):
    jl, tl = _landscapes(k)
    rng = np.random.default_rng(10 + k)
    parents = rng.random((4, LENGTH, 2)).astype(np.float32)
    parents /= parents.sum(-1, keepdims=True)
    want = jax.jit(functools.partial(jax_asr.parental_logits, site_chunk=site_chunk))(parents, jl)
    got = asr.parental_logits(torch.tensor(parents), tl, site_chunk=site_chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-7)


def _asr_inputs(seed, n_states=2):
    rng = np.random.default_rng(seed)
    n_all = 2 * N_LEAVES - 1
    leaves = rng.integers(0, n_states, (N_LEAVES, LENGTH)).astype(np.int32)
    masked = np.zeros((n_all, LENGTH, n_states), np.float32)
    masked[np.arange(N_LEAVES)[:, None], np.arange(LENGTH), leaves] = 1.0
    adjacency = np.asarray(jax_adjacency(jax_balanced(N_LEAVES)), np.float32)
    return leaves, masked, adjacency


@pytest.mark.parametrize("k", [1, 3])
def test_landscape_aware_loss_and_gradient(k):
    jl, tl = _landscapes(k)
    _, masked, adjacency = _asr_inputs(k)
    rng = np.random.default_rng(20 + k)
    ancestors = rng.normal(size=(N_LEAVES - 1, LENGTH, 2)).astype(np.float32)
    mask = rng.random(LENGTH) < 0.8

    def jax_fn(anc):
        return jax_asr.landscape_aware_loss(anc, jnp.asarray(masked), N_LEAVES, jl,
                                            jnp.asarray(adjacency), 0.7,
                                            site_mask=jnp.asarray(mask), site_chunk=7)

    value, grad = jax.jit(jax.value_and_grad(jax_fn))(ancestors)
    anc = torch.tensor(ancestors, requires_grad=True)
    got = asr.landscape_aware_loss(anc, torch.tensor(masked), N_LEAVES, tl,
                                   torch.tensor(adjacency), 0.7, site_mask=torch.tensor(mask),
                                   site_chunk=7)
    np.testing.assert_allclose(float(got.detach()), float(value), rtol=1e-5)
    got.backward()
    np.testing.assert_allclose(anc.grad.numpy(), np.asarray(grad), rtol=1e-4, atol=1e-7)


def _jax_walk_draws(key, n_all, branch_length, length, n_states):
    """Every node's MH draws, split from ``key`` as ``evolve_tree`` and
    ``_mh_edge_walk`` split it (the per-site hits and the coupled site both
    come from ``prop_k1``, as in the JAX walk)."""

    def node_draws(node_key):
        k, noise_key = jax.random.split(node_key)

        def step(k, _):
            k, choose_k, prop_k1, prop_k2, accept_k = jax.random.split(k, 5)
            return k, (jax.random.uniform(choose_k, ()),
                       jax.random.uniform(prop_k1, (length,)),
                       jax.random.randint(prop_k2, (length,), 0, n_states),
                       jax.random.randint(prop_k1, (), 0, length),
                       jax.random.uniform(accept_k, ()))

        _, steps = jax.lax.scan(step, k, None, length=branch_length)
        return (jax.random.normal(noise_key),) + steps

    draws = jax.jit(jax.vmap(node_draws))(jax.random.split(key, n_all))
    return nk.EdgeDraws(*(torch.tensor(np.asarray(d)) for d in draws))


def test_evolve_tree_on_jax_draws():
    """Three MH steps an edge, log-normal rate noise, K = 3."""
    k, branch_length, rate_noise_std = 3, 3, 0.5
    jl, tl = _landscapes(k)
    key = jax.random.PRNGKey(30 + k)
    root = np.random.default_rng(k).integers(0, 2, LENGTH).astype(np.int32)
    kwargs = dict(coupled_prob=0.5, rate_noise_std=rate_noise_std, branch_length=branch_length)
    want = jax_nk.evolve_tree(jl, jax_balanced(N_LEAVES), jnp.asarray(root), 0.2, key, **kwargs)
    draws = _jax_walk_draws(key, 2 * N_LEAVES - 1, branch_length, LENGTH, 2)
    got = nk.evolve_tree(tl, balanced_topology(N_LEAVES), torch.tensor(root), 0.2, draws=draws,
                         **kwargs)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    data = nk.evolve_tree_on_adjacency(
        tl, torch.tensor(np.asarray(jax_adjacency(jax_balanced(N_LEAVES)))), torch.tensor(root),
        0.2, draws=draws, **kwargs)
    np.testing.assert_array_equal(data.all_sequences.numpy(), np.asarray(want, np.float32))


def test_reconstruct_ancestors_from_jax_init():
    """200 Adam steps (clipped at norm 1, lr 1e-2) from JAX's initial logits."""
    n_states, steps, lr = 4, 200, 1e-2
    leaves, masked, adjacency = _asr_inputs(40, n_states)
    n_all = 2 * N_LEAVES - 1
    key = jax.random.PRNGKey(41)
    init = jax.random.normal(jax.random.split(key)[1], (N_LEAVES - 1, LENGTH, n_states))
    want, want_losses = jax_asr.reconstruct_ancestors(
        jnp.asarray(leaves), n_all, n_states, jnp.asarray(adjacency), key,
        learning_rate=lr, n_iterations=steps, return_losses=True)

    def jax_loss(anc):
        seqs = jax_soft_sequences(anc, jnp.asarray(masked), N_LEAVES)
        return jax_surrogate(seqs, jnp.asarray(adjacency))

    jax_logits, _ = jax.jit(lambda a: jax_asr._run_descent(
        jax_loss, a, jax_make_optimizer("adam", lr), steps, False))(init)
    np.testing.assert_array_equal(np.asarray(jax_logits).argmax(-1), np.asarray(want))

    got, losses = asr.reconstruct_ancestors(
        torch.tensor(leaves), n_all, n_states, torch.tensor(adjacency),
        init=torch.tensor(np.asarray(init)), learning_rate=lr, n_iterations=steps,
        return_losses=True)
    np.testing.assert_allclose(losses.numpy(), np.asarray(want_losses), rtol=1e-4)
    logits, _ = asr._run_descent(
        lambda a: surrogate_cost(soft_sequences(a, torch.tensor(masked), N_LEAVES),
                                 torch.tensor(adjacency)),
        torch.tensor(np.asarray(init)), "adam", lr, steps, False)
    jl = np.asarray(jax_logits)
    np.testing.assert_allclose(logits.numpy(), jl, atol=1e-4)
    np.testing.assert_array_equal(logits.argmax(-1).numpy(), got.numpy())
    top2 = np.sort(jl, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 1e-3
    np.testing.assert_array_equal(got.numpy()[clear], np.asarray(want)[clear])


def test_landscape_aware_reconstruction_and_mixed_precision():
    """The landscape-aware descent follows JAX's loss curve from JAX's
    init; the bfloat16 forward pass (parameters float32) runs and returns
    int32 ancestors."""
    jl, tl = _landscapes(2)
    leaves, _, adjacency = _asr_inputs(50)
    n_all = 2 * N_LEAVES - 1
    key = jax.random.PRNGKey(51)
    init = jax.random.normal(jax.random.split(key)[1], (N_LEAVES - 1, LENGTH, 2))
    _, want_losses = jax_asr.reconstruct_ancestors_landscape_aware(
        jnp.asarray(leaves), n_all, 2, jl, 0.5, jnp.asarray(adjacency), key,
        learning_rate=1e-2, n_iterations=40, return_losses=True, site_chunk=8)
    _, losses = asr.reconstruct_ancestors_landscape_aware(
        torch.tensor(leaves), n_all, 2, tl, 0.5, torch.tensor(adjacency),
        init=torch.tensor(np.asarray(init)), learning_rate=1e-2, n_iterations=40,
        return_losses=True, site_chunk=8)
    np.testing.assert_allclose(losses.numpy(), np.asarray(want_losses), rtol=1e-4)
    result = asr.reconstruct_ancestors(
        torch.tensor(leaves), n_all, 2, torch.tensor(adjacency),
        torch.Generator().manual_seed(0), n_iterations=5, mixed_precision=True,
        compute_dtype=torch.bfloat16)
    assert result.dtype == torch.int32 and result.shape == (N_LEAVES - 1, LENGTH)
