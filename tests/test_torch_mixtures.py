"""The rate-heterogeneity likelihoods of ``trex_tpu_torch/ops/likelihood.py``
against ``trex_tpu/ops/likelihood.py``: +G, +R and +G+I with their
gradients (``jax.grad``), ``per_site_log_likelihood`` and the per-site
pruning under given transition matrices.

Inputs are made with numpy from a seed and handed to both packages.
Likelihoods and per-site values within rtol 2e-5, gradients within rtol
1e-4 (atol 1e-4 of the largest).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import evolved_masks, parents_of, random_children

import trex_tpu.ops.likelihood as jl
import trex_tpu_torch.ops.likelihood as tl
from trex_tpu.topology import Topology as JaxTopology
from trex_tpu_torch.topology import Topology


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    children = random_children(rng, 7, 1)[0]
    parents = parents_of(children)
    masks = evolved_masks(rng, children, 48, 0.3)
    masks[1, :4] = 15  # fully ambiguous
    masks[2, 4:6] = 5  # A or G
    lengths = rng.uniform(0.05, 0.6, 13).astype(np.float32)
    rates = rng.uniform(0.3, 3.0, (4, 4)).astype(np.float32)
    rates = (rates + rates.T) / 2
    freqs = rng.dirichlet(np.ones(4)).astype(np.float32)
    weights = rng.integers(1, 4, 48).astype(np.float32)
    return dict(
        jax_topo=JaxTopology(jnp.asarray(children), jnp.asarray(parents)),
        topo=Topology(torch.as_tensor(children), torch.as_tensor(parents)),
        masks=masks, lengths=lengths, rates=rates, freqs=freqs, weights=weights,
    )


def _mixture(pkg, name, data, lengths, shape, rates, freqs, site_mask):
    masks = data["masks"]
    if pkg is jl:
        topo, arr, masks = data["jax_topo"], jnp.asarray, jnp.asarray(masks)
    else:
        topo, arr, masks = data["topo"], torch.as_tensor, torch.as_tensor(masks)
    model = dict(rates=None if rates is None else arr(rates),
                 freqs=None if freqs is None else arr(freqs),
                 sequences_are_masks=True)
    mask = None if site_mask is None else arr(site_mask)
    if name == "gamma":
        return pkg.tree_log_likelihood_gamma(topo, lengths, masks, 4, shape, 4, mask, **model)
    if name == "freerate":
        cat_rates = shape * arr(np.array([0.2, 0.9, 2.4], np.float32))
        cat_w = arr(np.array([0.5, 0.3, 0.2], np.float32))
        return pkg.tree_log_likelihood_freerate(topo, lengths, masks, 4, cat_rates, cat_w,
                                                mask, **model)
    return pkg.tree_log_likelihood_gamma_invariant(topo, lengths, masks, 4, shape, 0.15, 4,
                                                   mask, **model)


@pytest.mark.parametrize("name, gtr", [
    ("gamma", True), ("freerate", True), ("gamma_invariant", True), ("gamma_invariant", False),
])
def test_mixture_likelihoods_and_gradients(data, name, gtr):
    """Value and gradients in the lengths, the shape, the exchangeabilities
    and the frequencies (GTR through the matrix exponential), and in JC69."""
    shape = np.float32(0.7)

    def jax_fn(lengths, shape, rates, freqs):
        return _mixture(jl, name, data, lengths, shape, rates if gtr else None,
                        freqs if gtr else None, jnp.asarray(data["weights"]))

    args = [jnp.asarray(data["lengths"]), jnp.asarray(shape), jnp.asarray(data["rates"]),
            jnp.asarray(data["freqs"])]
    value_j, grads_j = jax.jit(jax.value_and_grad(jax_fn, argnums=(0, 1, 2, 3)))(*args)
    tensors = [torch.tensor(np.asarray(a), requires_grad=True) for a in args]
    value_t = _mixture(tl, name, data, tensors[0], tensors[1],
                       tensors[2] if gtr else None, tensors[3] if gtr else None,
                       data["weights"])
    value_t.backward()
    np.testing.assert_allclose(float(value_t.detach()), float(value_j), rtol=2e-5)
    for t, g in zip(tensors, grads_j):
        g = np.asarray(g)
        got = np.zeros_like(g) if t.grad is None else t.grad.numpy()
        np.testing.assert_allclose(got, g, rtol=1e-4, atol=1e-4 * max(np.abs(g).max(), 1e-3))


@pytest.mark.parametrize("gamma_shape", [None, 0.4])
def test_per_site_log_likelihood(data, gamma_shape):
    got = tl.per_site_log_likelihood(
        data["topo"], torch.as_tensor(data["lengths"]), torch.as_tensor(data["masks"]), 4,
        torch.as_tensor(data["rates"]), torch.as_tensor(data["freqs"]),
        gamma_shape=gamma_shape, n_categories=3, sequences_are_masks=True)
    want = jax.jit(lambda *a: jl.per_site_log_likelihood(
        *a, gamma_shape=gamma_shape, n_categories=3, sequences_are_masks=True),
        static_argnums=(3,))(
        data["jax_topo"], jnp.asarray(data["lengths"]), jnp.asarray(data["masks"]), 4,
        jnp.asarray(data["rates"]), jnp.asarray(data["freqs"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5)


def test_per_site_with_transition_matrices(data):
    """Given P a branch and a root prior, the model arguments are skipped;
    integer states with missing (-1) leaves."""
    rng = np.random.default_rng(3)
    pm = rng.dirichlet(np.ones(4), (13, 4)).astype(np.float32)
    prior = rng.dirichlet(np.ones(4)).astype(np.float32)
    states = rng.integers(-1, 4, (7, 30)).astype(np.int32)
    got = tl._per_site_log_likelihood(
        data["topo"], None, torch.as_tensor(states), 4,
        transition_matrices=torch.as_tensor(pm), root_prior=torch.as_tensor(prior))
    want = jax.jit(lambda t, s, p, r: jl._per_site_log_likelihood(
        t, None, s, 4, transition_matrices=p, root_prior=r))(
        data["jax_topo"], jnp.asarray(states), jnp.asarray(pm), jnp.asarray(prior))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5)
    with pytest.raises(ValueError, match="root_prior"):
        tl._per_site_log_likelihood(data["topo"], None, torch.as_tensor(states), 4,
                                    transition_matrices=torch.as_tensor(pm))
