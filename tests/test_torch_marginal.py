"""Stepping-stone marginal likelihoods (``search/marginal.py``): replayed
against the JAX package under its key schedule (``_torch_parity.
JaxDraws``) for JC and for GTR with its simplices integrated (the same
accepts, log ratios within rtol 2e-5, no near-tied accept; 7 taxa x 80
sites, 8 rungs, 12 generations), and the port alone against the 2-taxon
JC marginal by 1-D quadrature."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import (
    JaxDraws,
    evolved_masks,
    jax_marginal_step,
    near_tie_accepts,
    parents_of,
    random_children,
    record_accepts,
)

import trex_tpu.search.marginal as jax_marginal
from trex_tpu.topology import Topology as JaxTopology
from trex_tpu_torch.alignment import compress_alignment
from trex_tpu_torch.ops.likelihood import jc69_transition
from trex_tpu_torch.ops.likelihood_cuda import batched_log_likelihood_plain
from trex_tpu_torch.search.marginal import stepping_stone
from trex_tpu_torch.topology import from_numpy


@pytest.mark.parametrize("sample_model,seed", [(False, 1), (True, 2)])
def test_replayed_stepping_stone_equals_jax(sample_model, seed, monkeypatch):
    rng = np.random.default_rng(31)
    children = random_children(rng, 7, 1)[0]
    patterns, weights = compress_alignment(evolved_masks(rng, children, 80, 0.12))
    patterns, weights = patterns.astype(np.int32), weights.astype(np.float32)
    parents = parents_of(children)
    common = dict(n_rungs=8, n_generations=12, sample_model=sample_model,
                  sequences_are_masks=True)
    want = jax_marginal.stepping_stone(
        jax.random.PRNGKey(seed), JaxTopology(children=jnp.asarray(children),
                                              parents=jnp.asarray(parents)),
        jnp.asarray(patterns), 4, site_weights=jnp.asarray(weights), **common)
    margins = record_accepts(monkeypatch)
    got = stepping_stone(from_numpy(children, parents), patterns, 4, seed=seed,
                         draws=JaxDraws(*jax_marginal_step(jax.random.PRNGKey(seed), 24,
                                                           sample_model)),
                         device="cpu", site_weights=weights, **common)
    assert near_tie_accepts(margins, abs(want["log_marginal"])) == 0
    assert got["acceptance"] == want["acceptance"]
    np.testing.assert_allclose(got["log_ratios"], want["log_ratios"], rtol=2e-5, atol=1e-6)
    assert got["log_marginal"] == pytest.approx(want["log_marginal"], rel=2e-5)
    np.testing.assert_array_equal(got["betas"], want["betas"])
    assert got["ess_min"] == pytest.approx(want["ess_min"], rel=1e-3)


def test_two_taxon_marginal_matches_quadrature():
    """With 2 taxa the JC likelihood depends on s = t0 + t1 alone, whose
    prior is Gamma(2, 1 / mean): Z = int L(s) Gamma(s) ds."""
    rng = np.random.default_rng(0)
    length = 200
    a = rng.integers(0, 4, length)
    b = np.where(rng.uniform(size=length) < 0.12, (a + rng.integers(1, 4, length)) % 4, a)
    leaves = np.stack([a, b]).astype(np.int32)
    grid = np.linspace(1e-5, 2.0, 20000)
    lengths = np.zeros((grid.size, 3), np.float32)
    lengths[:, 0] = grid
    lnl = batched_log_likelihood_plain(
        torch.tensor([[[0, 1]]], dtype=torch.int32).expand(grid.size, 1, 2).contiguous(),
        torch.as_tensor(leaves), torch.ones(length), torch.full((4,), 0.25),
        jc69_transition(torch.as_tensor(lengths), 4)).numpy().astype(np.float64)
    rate = 10.0
    log_prior = 2 * np.log(rate) + np.log(grid) - rate * grid
    integrand = lnl + log_prior
    m = integrand.max()
    exact = m + np.log(np.trapezoid(np.exp(integrand - m), grid))
    topo = from_numpy(np.array([[0, 1]], np.int32), np.array([2, 2, 2], np.int32))
    res = stepping_stone(topo, leaves, 4, seed=3, device="cpu", n_rungs=16,
                         n_generations=600)
    assert abs(res["log_marginal"] - exact) < 0.5
    assert 0.2 < res["acceptance"] < 0.95
