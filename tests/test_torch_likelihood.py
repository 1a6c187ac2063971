"""Parity of the port's pruning likelihood (``trex_tpu_torch.ops.likelihood``)
with trex_tpu's.

Tolerances: transition matrices rtol 1e-6 (float32 closed forms; GTR also
atol 1e-6, see below); log-likelihoods rtol 2e-5, the reference's own
(``tests/test_likelihood_pallas.py``): float32 sums in another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import integer_weights, parents_of, random_children, random_masks

from trex_tpu.ops import likelihood as jl
from trex_tpu.topology import Topology as JaxTopology
from trex_tpu_torch.ops import likelihood as tl
from trex_tpu_torch.topology import Topology, from_numpy

N_LEAVES, LENGTH = 10, 160


def _gtr(rng, q=4):
    rates = np.abs(rng.normal(1.0, 0.4, (q, q))).astype(np.float32)
    rates = (rates + rates.T) / 2
    freqs = rng.dirichlet(np.full(q, 3.0)).astype(np.float32)
    return rates, freqs


@pytest.mark.parametrize("q", [4, 20])
def test_jc69_transition_matches_jax(q):
    for t in (1e-3, 0.1, 0.7, 3.0):
        ours = tl.jc69_transition(t, q)
        assert ours.dtype == torch.float32
        np.testing.assert_allclose(
            ours.numpy(), np.asarray(jl.jc69_transition(jnp.float32(t), q)), rtol=1e-6
        )
    lengths = np.random.default_rng(0).uniform(0.05, 1.0, (3, 5)).astype(np.float32)
    batched = tl.jc69_transition(torch.as_tensor(lengths), q)
    assert batched.shape == (3, 5, q, q)
    np.testing.assert_allclose(
        batched[1, 2].numpy(), np.asarray(jl.jc69_transition(jnp.float32(lengths[1, 2]), q)),
        rtol=1e-6,
    )


def test_gtr_generator_and_transition_match_jax():
    rates, freqs = _gtr(np.random.default_rng(1))
    np.testing.assert_allclose(
        tl.gtr_generator(torch.as_tensor(rates), torch.as_tensor(freqs)).numpy(),
        np.asarray(jl.gtr_generator(jnp.asarray(rates), jnp.asarray(freqs))),
        rtol=1e-6, atol=1e-7,
    )
    ours_eig = tl.gtr_eigensystem(torch.as_tensor(rates), torch.as_tensor(freqs))
    ref_eig = jl.gtr_eigensystem(jnp.asarray(rates), jnp.asarray(freqs))
    # The two libraries' float32 eigh round differently, by a few float32
    # ulps of the generator's norm: absolute 1e-6 on P, whose small entries
    # hold no relative 1e-6.
    np.testing.assert_allclose(ours_eig[0].numpy(), np.asarray(ref_eig[0]), rtol=1e-6, atol=1e-6)
    for t in (0.05, 0.3, 1.5):
        ours = tl.gtr_transition(t, *ours_eig)
        # Eigenvector signs may differ between the two eigh's; P does not.
        np.testing.assert_allclose(
            ours.numpy(), np.asarray(jl.gtr_transition(jnp.float32(t), *ref_eig)),
            rtol=1e-6, atol=1e-6,
        )
        np.testing.assert_allclose(ours.sum(dim=1).numpy(), 1.0, rtol=1e-6)


def _inputs(seed, batch=1):
    rng = np.random.default_rng(seed)
    children = random_children(rng, N_LEAVES, batch)
    blens = rng.uniform(0.02, 0.8, (batch, 2 * N_LEAVES - 1)).astype(np.float32)
    return rng, children, blens


@pytest.mark.parametrize("mode", ["masks", "states"])
def test_tree_log_likelihood_matches_jax(mode):
    rng, children, blens = _inputs(2 if mode == "masks" else 3)
    if mode == "masks":
        leaves = random_masks(rng, N_LEAVES, LENGTH, ambiguity=0.15)
    else:
        leaves = rng.integers(-1, 4, (N_LEAVES, LENGTH)).astype(np.int32)  # -1 = missing
    weights = integer_weights(rng, LENGTH)
    masks = mode == "masks"
    ours = tl.tree_log_likelihood(
        from_numpy(children[0], parents_of(children[0])), torch.as_tensor(blens[0]),
        torch.as_tensor(leaves), 4, site_mask=torch.as_tensor(weights),
        sequences_are_masks=masks,
    )
    ref = jl.tree_log_likelihood(
        JaxTopology(jnp.asarray(children[0]), jnp.asarray(parents_of(children[0]))),
        jnp.asarray(blens[0]), jnp.asarray(leaves), 4, site_mask=jnp.asarray(weights),
        sequences_are_masks=masks,
    )
    assert ours.dtype == torch.float32
    np.testing.assert_allclose(float(ours), float(ref), rtol=2e-5)


def test_gtr_and_batched_log_likelihood_match_jax():
    rng, children, blens = _inputs(4, batch=3)
    leaves = rng.integers(0, 4, (N_LEAVES, LENGTH)).astype(np.int32)
    rates, freqs = _gtr(rng)
    ours = tl.batched_tree_log_likelihood(
        Topology(torch.as_tensor(children), torch.as_tensor(parents_of(children))),
        torch.as_tensor(blens), torch.as_tensor(leaves), 4,
        rates=torch.as_tensor(rates), freqs=torch.as_tensor(freqs),
    )
    for b in range(3):
        ref = jl.tree_log_likelihood(
            JaxTopology(jnp.asarray(children[b]), jnp.asarray(parents_of(children[b]))),
            jnp.asarray(blens[b]), jnp.asarray(leaves), 4,
            rates=jnp.asarray(rates), freqs=jnp.asarray(freqs),
        )
        np.testing.assert_allclose(float(ours[b]), float(ref), rtol=2e-5)


def test_numpy_float64_inputs_stay_float32():
    rng, children, blens = _inputs(5)
    leaves = rng.integers(0, 4, (N_LEAVES, LENGTH)).astype(np.int32)
    out = tl.tree_log_likelihood(
        from_numpy(children[0], parents_of(children[0])), blens[0].astype(np.float64),
        torch.as_tensor(leaves), 4, site_mask=np.ones(LENGTH),
    )
    assert out.dtype == torch.float32
    assert tl.jc69_transition(np.float64(0.1), 4).dtype == torch.float32
