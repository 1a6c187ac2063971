"""The port's MC^3 sampler (``search/mcmc.py``) replayed against the JAX
package's: both start from the same numpy state (``default_rng(seed)``),
the port draws the JAX key schedule's values (``_torch_parity.JaxDraws``),
and after the same generations the two checkpoints hold the same children,
samples, accept counters and key, lengths and lnL within rtol 2e-5. The
fixtures have no accept whose log u lies within 1e-6 |lnL| (> 1e-5) of its
log alpha (counted). This file: the informed proposal under a fixed GTR
model (2 runs x 2 chains, 2 branch moves), the host carries, ESS, ASDSF
and the simplex helpers; ``test_torch_mcmc_model.py`` the uniform NNI
proposal with sampled GTR simplices, ``test_torch_mcmc_resume.py`` the
JC informed sampler resumed from a JAX checkpoint. 7 taxa x 80 sites."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import (
    JaxDraws,
    evolved_masks,
    jax_mcmc_step,
    near_tie_accepts,
    random_children,
    record_accepts,
)

import trex_tpu.search.mcmc as jax_mcmc
from trex_tpu.topology import Topology as JaxTopology
from trex_tpu_torch.alignment import compress_alignment
from trex_tpu_torch.search import mcmc
from trex_tpu_torch.topology import from_numpy

N_TAXA, N_SITES = 7, 80
GTR = (np.array([[0, 1.2, 4.0, 0.6], [1.2, 0, 0.9, 3.3], [4.0, 0.9, 0, 1.0],
                 [0.6, 3.3, 1.0, 0]], np.float32),
       np.array([0.3, 0.2, 0.22, 0.28], np.float32))


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    masks = evolved_masks(rng, random_children(rng, N_TAXA, 1)[0], N_SITES, 0.12)
    patterns, weights = compress_alignment(masks)
    return patterns.astype(np.int32), weights.astype(np.float32)


CASES = {
    # name: (mcmc_sample keywords, generations, seed)
    "informed_gtr": (dict(n_runs=2, n_chains=2, branch_moves_per_gen=2,
                          topo_proposal="informed", rates=GTR[0], freqs=GTR[1]), 30, 3),
    "uniform_full_bayes": (dict(n_runs=1, n_chains=2, branch_moves_per_gen=1,
                                topo_proposal="nni", sample_model=True), 20, 5),
    "informed_jc": (dict(n_runs=2, n_chains=2, branch_moves_per_gen=2,
                         topo_proposal="informed"), 20, 3),
    "informed_gtr_g": (dict(n_runs=1, n_chains=2, branch_moves_per_gen=1,
                            topo_proposal="informed", rates=GTR[0], freqs=GTR[1],
                            gamma_shape=0.6), 20, 7),
    "informed_full_bayes_g": (dict(n_runs=1, n_chains=2, branch_moves_per_gen=1,
                                   topo_proposal="informed", sample_model=True,
                                   gamma_shape=0.6), 20, 9),
}


def jax_keywords(kw: dict) -> dict:
    return {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}


def run_both(tmp_path, data, name, monkeypatch):
    kw, gens, seed = CASES[name]
    patterns, weights = data
    common = dict(n_generations=gens, sample_every=10, burnin_frac=0.25,
                  sequences_are_masks=True, checkpoint_every=10**6, **kw)
    jax_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    want = jax_mcmc.mcmc_sample(jax.random.PRNGKey(seed), jnp.asarray(patterns), 4,
                                site_weights=jnp.asarray(weights), checkpoint_dir=jax_dir,
                                **jax_keywords(common))
    step = jax_mcmc_step(kw["branch_moves_per_gen"], kw.get("sample_model", False),
                         kw["topo_proposal"], kw["n_chains"] > 1)
    draws = JaxDraws(jax.random.PRNGKey(seed), step)
    margins = record_accepts(monkeypatch)
    got = mcmc.mcmc_sample(patterns, 4, seed=seed, draws=draws, device="cpu",
                           site_weights=weights, checkpoint_dir=port_dir, **common)
    return want, got, margins, np.load(os.path.join(jax_dir, "mcmc_checkpoint.npz")), \
        np.load(os.path.join(port_dir, "mcmc_checkpoint.npz"))


def assert_same_run(want, got, jax_ck, port_ck, margins):
    scale = float(np.abs(port_ck["lnl"]).max())
    assert near_tie_accepts(margins, scale) == 0
    for key in ("children", "acc", "s_children", "s_run", "gens_done"):
        np.testing.assert_array_equal(port_ck[key], jax_ck[key], err_msg=key)
    np.testing.assert_array_equal(port_ck["draws_state"], jax_ck["jax_key"])
    for key in ("lengths", "lnl", "s_lengths", "s_lnl", "rates", "freqs"):
        np.testing.assert_allclose(port_ck[key], jax_ck[key], rtol=2e-5, atol=1e-6, err_msg=key)
    np.testing.assert_array_equal(got.sample_children, want.sample_children)
    assert got.consensus_newick == want.consensus_newick
    assert got.acceptance == pytest.approx(want.acceptance)
    assert got.split_posterior == pytest.approx(want.split_posterior)
    assert got.asdsf == pytest.approx(want.asdsf)
    assert got.ess_lnl == pytest.approx(want.ess_lnl, rel=1e-3)
    np.testing.assert_allclose(got.mean_lengths, want.mean_lengths, rtol=2e-5, atol=1e-6)


def test_replayed_trajectory_equals_jax(tmp_path, data, monkeypatch):
    want, got, margins, jax_ck, port_ck = run_both(tmp_path, data, "informed_gtr", monkeypatch)
    assert_same_run(want, got, jax_ck, port_ck, margins)
    assert (port_ck["acc"][:3] > 0).all()


def test_host_carries_equal_jax():
    rng = np.random.default_rng(4)
    n = 9
    children = random_children(rng, n, 1)[0]
    lengths = rng.exponential(0.1, 2 * n - 1).astype(np.float32)
    from trex_tpu.io import nni_neighbors_host as jax_nni
    from trex_tpu_torch.io import nni_neighbors_host

    topo = from_numpy(children, np.zeros(2 * n - 1, np.int32))
    nbr_c, _ = nni_neighbors_host(topo)
    salt = rng.integers(1, 2**63, n, dtype=np.uint64)
    got = mcmc._carry_lengths_nni_batch(children, lengths, nbr_c, n, salt)
    want = jax_mcmc._carry_lengths_nni_batch(children, lengths, nbr_c, n, salt)
    np.testing.assert_array_equal(got, want)
    jax_nbrs, _ = jax_nni(JaxTopology(children=jnp.asarray(children),
                                      parents=jnp.zeros(2 * n - 1, jnp.int32)))
    np.testing.assert_array_equal(nbr_c, np.asarray(jax_nbrs))
    for j in range(nbr_c.shape[0]):
        one = mcmc.carry_lengths_nni(topo, lengths, from_numpy(nbr_c[j], np.zeros(2 * n - 1)))
        np.testing.assert_array_equal(one, got[j])
        np.testing.assert_array_equal(one, jax_mcmc.carry_lengths_nni(
            JaxTopology(children=jnp.asarray(children), parents=jnp.zeros(2 * n - 1)),
            lengths, JaxTopology(children=jnp.asarray(nbr_c[j]), parents=jnp.zeros(2 * n - 1))))
    np.testing.assert_array_equal(mcmc._clade_hash_batch(nbr_c, n, salt),
                                  jax_mcmc._clade_hash_batch(nbr_c, n, salt))


def test_diagnostics_equal_jax():
    rng = np.random.default_rng(6)
    for trace in (rng.normal(size=300), np.cumsum(rng.normal(size=200)), np.ones(50),
                  rng.normal(size=3)):
        assert mcmc.effective_sample_size(trace) == jax_mcmc.effective_sample_size(trace)
    runs_np = [random_children(rng, 6, 12) for _ in range(3)]
    zero = np.zeros(11, np.int32)
    got = mcmc.average_stddev_split_freqs(
        [[from_numpy(c, zero) for c in run] for run in runs_np])
    want = jax_mcmc.average_stddev_split_freqs(
        [[JaxTopology(children=jnp.asarray(c), parents=jnp.asarray(zero)) for c in run]
         for run in runs_np])
    assert got == pytest.approx(want, abs=0)
    assert mcmc.average_stddev_split_freqs([[from_numpy(c, zero) for c in runs_np[0]]]) is None
    x = torch.tensor([[0.2, 0.3, 0.5], [0.1, 0.1, 0.8]])
    alpha = torch.tensor([[2.0, 3.0, 1.5], [50.0, 10.0, 100.0]])
    want = [float(jax_mcmc._dirichlet_logpdf(jnp.asarray(x[i].numpy()),
                                             jnp.asarray(alpha[i].numpy()))) for i in range(2)]
    np.testing.assert_allclose(mcmc._dirichlet_logpdf(x, alpha).numpy(), want, rtol=1e-5)
    vec = torch.tensor([0.1, 0.2, 0.05, 0.3, 0.15, 0.2])
    np.testing.assert_array_equal(mcmc._pairs_to_matrix(vec, 4).numpy(),
                                  np.asarray(jax_mcmc._pairs_to_matrix(jnp.asarray(vec), 4)))
    np.testing.assert_array_equal(mcmc._matrix_to_pairs(GTR[0], 4),
                                  jax_mcmc._matrix_to_pairs(GTR[0], 4))
