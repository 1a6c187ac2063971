"""The ML NNI climb at Q = 61 against the JAX package's: the port refused
it (``ValueError``) while its likelihood kernel took only Q = 4 and 20, and
JAX returns a tree. Now both return the same tree and rounds, the ranking
score within rtol 2e-5 (the port ranks with K3/K4's plain version on the
CPU, JAX with lax). The JAX climb's per-tree lax likelihood is jitted here,
as the other ML parity tests jit the JAX side's calls, to keep the file
short."""

import jax
import jax.numpy as jnp
import numpy as np
from _torch_parity import parents_of, random_children

import trex_tpu.search.ml as jax_ml
from trex_tpu.topology import Topology as JaxTopology
from trex_tpu.topology import balanced_topology as jax_balanced
from trex_tpu_torch.search.ml import ml_hill_climb
from trex_tpu_torch.topology import balanced_topology, from_numpy

Q = 61


def _jitted_jax_likelihood(monkeypatch):
    monkeypatch.setattr(jax_ml, "tree_log_likelihood", jax.jit(
        jax_ml.tree_log_likelihood, static_argnums=(3,),
        static_argnames=("sequences_are_masks",)))


def test_ml_nni_climb_at_61_states_equals_jax(monkeypatch):
    # balanced_topology(8), 8 x 40 random codon states, JC exchangeabilities
    # and uniform frequencies, NNI, 2 rounds, no final fit.
    _jitted_jax_likelihood(monkeypatch)
    rng = np.random.default_rng(0)
    states = rng.integers(0, Q, (8, 40)).astype(np.int32)
    rates = (np.ones((Q, Q)) - np.eye(Q)).astype(np.float32)
    freqs = np.full(Q, 1.0 / Q, np.float32)
    kw = dict(neighborhood="nni", max_rounds=2, optimize_final_lengths=False)
    want, _, _ = jax_ml.ml_hill_climb(jax_balanced(8), jnp.asarray(states), Q,
                                      rates=jnp.asarray(rates), freqs=jnp.asarray(freqs), **kw)
    got, _, _ = ml_hill_climb(balanced_topology(8), states, Q, rates=rates, freqs=freqs,
                              device="cpu", **kw)
    np.testing.assert_array_equal(got.topology.children.numpy(),
                                  np.asarray(want.topology.children))
    np.testing.assert_allclose(got.score, float(want.score), rtol=2e-5)
    np.testing.assert_allclose(got.score, 1672.039, rtol=2e-5)
    assert got.rounds == want.rounds


def test_ml_nni_climb_at_5_states_with_weights_equals_jax(monkeypatch):
    # A 5-state GTR model on 7 taxa with 5% missing states and pattern
    # weights, from a random start: the runtime-Q path below 20 states.
    _jitted_jax_likelihood(monkeypatch)
    rng = np.random.default_rng(3)
    states = rng.integers(0, 5, (7, 60)).astype(np.int32)
    states[rng.random(states.shape) < 0.05] = -1
    weights = rng.integers(1, 4, 60).astype(np.float32)
    rates = rng.gamma(2.0, 1.0, (5, 5))
    rates = ((rates + rates.T) / 2).astype(np.float32)
    freqs = rng.dirichlet(np.full(5, 5.0)).astype(np.float32)
    start = random_children(rng, 7, 1)[0]
    kw = dict(neighborhood="nni", max_rounds=3, optimize_final_lengths=False)
    want, _, _ = jax_ml.ml_hill_climb(
        JaxTopology(jnp.asarray(start), jnp.asarray(parents_of(start))), jnp.asarray(states), 5,
        site_weights=jnp.asarray(weights), rates=jnp.asarray(rates), freqs=jnp.asarray(freqs),
        **kw)
    got, _, _ = ml_hill_climb(from_numpy(start, parents_of(start)), states, 5,
                              site_weights=weights, rates=rates, freqs=freqs, device="cpu", **kw)
    np.testing.assert_array_equal(got.topology.children.numpy(),
                                  np.asarray(want.topology.children))
    np.testing.assert_allclose(got.score, float(want.score), rtol=2e-5)
    assert got.rounds == want.rounds
