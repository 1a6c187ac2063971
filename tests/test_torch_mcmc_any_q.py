"""The port's MC^3 sampler at Q = 5 (the samplers refused every Q but 4 and
20 while K4 took only those): 5 taxa of 5-state characters with missing
data, the informed NNI proposal, replayed against the JAX sampler under its
key schedule (``_torch_parity.JaxDraws``) as ``test_torch_mcmc.py`` replays
the 4-state cases: the same children, samples, accept counters and key,
lengths and lnL within rtol 2e-5, no accept within 1e-6 |lnL| of its
threshold."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from _torch_parity import (
    JaxDraws,
    jax_mcmc_step,
    near_tie_accepts,
    random_children,
    record_accepts,
)

import trex_tpu.search.mcmc as jax_mcmc
from trex_tpu_torch.alignment import compress_alignment
from trex_tpu_torch.search import mcmc

Q, N_TAXA, N_SITES = 5, 5, 60


def _states(rng):
    """(N_TAXA, N_SITES) states evolved down a random tree (each site
    changes with probability 0.15 an edge), 5% of them missing (-1)."""
    children = random_children(rng, N_TAXA, 1)[0]
    seqs = np.empty((2 * N_TAXA - 1, N_SITES), np.int64)
    seqs[-1] = rng.integers(0, Q, N_SITES)
    for a in range(N_TAXA - 2, -1, -1):
        for c in children[a]:
            s = seqs[N_TAXA + a].copy()
            hit = rng.random(N_SITES) < 0.15
            s[hit] = rng.integers(0, Q, int(hit.sum()))
            seqs[c] = s
    states = seqs[:N_TAXA].astype(np.int32)
    states[rng.random(states.shape) < 0.05] = -1
    return states


def test_informed_sampler_at_5_states_equals_jax(tmp_path, monkeypatch):
    patterns, weights = compress_alignment(_states(np.random.default_rng(21)))
    patterns, weights = patterns.astype(np.int32), weights.astype(np.float32)
    kw = dict(n_runs=1, n_chains=2, branch_moves_per_gen=1, topo_proposal="informed")
    common = dict(n_generations=20, sample_every=10, burnin_frac=0.25,
                  checkpoint_every=10**6, **kw)
    jax_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    want = jax_mcmc.mcmc_sample(jax.random.PRNGKey(2), jnp.asarray(patterns), Q,
                                site_weights=jnp.asarray(weights), checkpoint_dir=jax_dir,
                                **common)
    draws = JaxDraws(jax.random.PRNGKey(2), jax_mcmc_step(1, False, "informed", True))
    margins = record_accepts(monkeypatch)
    got = mcmc.mcmc_sample(patterns, Q, seed=2, draws=draws, device="cpu",
                           site_weights=weights, checkpoint_dir=port_dir, **common)
    jax_ck = np.load(os.path.join(jax_dir, "mcmc_checkpoint.npz"))
    port_ck = np.load(os.path.join(port_dir, "mcmc_checkpoint.npz"))
    assert near_tie_accepts(margins, float(np.abs(port_ck["lnl"]).max())) == 0
    for key in ("children", "acc", "s_children", "s_run", "gens_done"):
        np.testing.assert_array_equal(port_ck[key], jax_ck[key], err_msg=key)
    np.testing.assert_array_equal(port_ck["draws_state"], jax_ck["jax_key"])
    for key in ("lengths", "lnl", "s_lengths", "s_lnl"):
        np.testing.assert_allclose(port_ck[key], jax_ck[key], rtol=2e-5, atol=1e-6, err_msg=key)
    np.testing.assert_array_equal(got.sample_children, want.sample_children)
    assert got.acceptance == pytest.approx(want.acceptance)
    assert (port_ck["acc"] > 0).any()
