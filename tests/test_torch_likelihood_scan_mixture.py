"""The rate mixture in the analytic ML SPR scan and in ``ml_hill_climb`` of
the port against the JAX package: the ranking matrix and base score under
+G (``gamma_shape``) and an explicit mixture with a rate-0 class
(``category_rates``/``category_weights``, as ``infer --model-rounds``
ranks +I), and the climbs under each; the NNI climb's Adam fit; the
refusal of a mixture on an enumerating neighbourhood.

Scores within rtol 2e-5 with the same +inf pattern; climbs with the same
topology, rounds and evaluations, scores within rtol 2e-5, fitted curves
within rtol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import evolved_masks, parents_of, random_children

import trex_tpu.ops.likelihood_scan as js
import trex_tpu.search.ml as jm
import trex_tpu_torch.ops.likelihood_scan as ts
import trex_tpu_torch.search.ml as tm
from trex_tpu.topology import Topology as JaxTopology
from trex_tpu_torch.topology import Topology

MIXTURES = {
    "gamma": dict(gamma_shape=np.float32(0.6)),
    "categories": dict(category_rates=np.array([0.4, 1.0, 1.9, 0.0], np.float32),
                       category_weights=np.array([0.3, 0.3, 0.25, 0.15], np.float32)),
}


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(21)
    truth = random_children(rng, 9, 1)[0]
    masks = evolved_masks(rng, truth, 50, 0.35)
    start = random_children(rng, 9, 1)[0]
    rates = rng.uniform(0.4, 2.5, (4, 4)).astype(np.float32)
    rates = (rates + rates.T) / 2
    freqs = rng.dirichlet(np.full(4, 5.0)).astype(np.float32)
    weights = rng.integers(1, 4, 50).astype(np.float32)
    return dict(masks=masks, start=start, rates=rates, freqs=freqs, weights=weights)


def _topos(children):
    parents = parents_of(children)
    return (JaxTopology(jnp.asarray(children), jnp.asarray(parents)),
            Topology(torch.as_tensor(children), torch.as_tensor(parents)))


@pytest.mark.parametrize("mixture", sorted(MIXTURES))
def test_scan_ranking_matrix(data, mixture):
    jax_topo, topo = _topos(data["start"])
    kw = MIXTURES[mixture]
    want, base_j = js.likelihood_spr_scan(
        jax_topo, jnp.asarray(data["masks"]), 4, 0.1, jnp.asarray(data["weights"]),
        rates=jnp.asarray(data["rates"]), freqs=jnp.asarray(data["freqs"]),
        sequences_are_masks=True, **{k: jnp.asarray(v) for k, v in kw.items()})
    got, base_t = ts.likelihood_spr_scan(
        topo, torch.as_tensor(data["masks"]), 4, 0.1, torch.as_tensor(data["weights"]),
        rates=torch.as_tensor(data["rates"]), freqs=torch.as_tensor(data["freqs"]),
        sequences_are_masks=True, prune_chunk=5,
        **{k: torch.as_tensor(v) for k, v in kw.items()})
    want, got = np.asarray(want), got.numpy()
    finite = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), finite)
    np.testing.assert_allclose(got[finite], want[finite], rtol=2e-5)
    np.testing.assert_allclose(float(base_t), float(base_j), rtol=2e-5)


def _climb(pkg, data, start, gtr=True, **kw):
    jax_topo, topo = _topos(start)
    arr = jnp.asarray if pkg is jm else torch.as_tensor
    extra = {} if pkg is jm else dict(device="cpu")
    if gtr:
        extra.update(rates=arr(data["rates"]), freqs=arr(data["freqs"]))
    return pkg.ml_hill_climb(
        jax_topo if pkg is jm else topo, arr(data["masks"]), 4,
        sequences_are_masks=True, site_weights=arr(data["weights"]),
        **{k: arr(v) if isinstance(v, np.ndarray | np.floating) else v for k, v in kw.items()},
        **extra)


def _same_climb(got, want, curve_rtol=2e-5):
    (r_t, lengths_t, curve_t), (r_j, lengths_j, curve_j) = got, want
    np.testing.assert_array_equal(r_t.topology.children.numpy(), np.asarray(r_j.topology.children))
    assert (r_t.rounds, r_t.evaluations) == (r_j.rounds, r_j.evaluations)
    np.testing.assert_allclose(r_t.score, r_j.score, rtol=2e-5)
    np.testing.assert_allclose(curve_t.numpy(), np.asarray(curve_j), rtol=curve_rtol)
    return r_t


@pytest.mark.parametrize("mixture", sorted(MIXTURES))
def test_scan_climb_under_a_mixture(data, mixture):
    kw = dict(neighborhood="spr-scan", **MIXTURES[mixture])
    result = _same_climb(_climb(tm, data, data["start"], **kw),
                         _climb(jm, data, data["start"], **kw))
    assert result.rounds > 0


def test_nni_climb_with_adam(data, monkeypatch):
    """An enumerating neighbourhood (JC69) with the Adam length fit. The
    JAX climb's CPU ranking (``jax.vmap`` of ``tree_log_likelihood``) runs
    jitted: the same function, compiled once for the round's batch."""
    monkeypatch.setattr(jm, "tree_log_likelihood", jax.jit(
        jm.tree_log_likelihood, static_argnums=(3,), static_argnames=("sequences_are_masks",)))
    kw = dict(neighborhood="nni", max_rounds=4, length_optimizer="adam",
              n_length_iterations=25, gtr=False)
    want = _climb(jm, data, data["start"], **kw)
    result = _same_climb(_climb(tm, data, data["start"], **kw), want, curve_rtol=1e-4)
    assert result.rounds > 0


def test_mixture_needs_the_scan(data):
    for pkg in (jm, tm):
        with pytest.raises(ValueError, match="spr-scan"):
            _climb(pkg, data, data["start"], neighborhood="nni", gamma_shape=np.float32(1.0))
