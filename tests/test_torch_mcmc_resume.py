"""The JC informed sampler resumed by the port from a JAX checkpoint: the
JAX package stops after 10 of 20 generations, ``McmcState.from_numpy``
and the saved key (as the draw source's state) carry its state across,
and the port's resumed run ends where the port's uninterrupted replay of
the same key schedule ends: the same children, accepts, samples and key,
lnL and lengths within rtol 2e-5 (the resumed leg starts from JAX's lnL,
the uninterrupted one from K4's). Also K4's evaluator of the samplers
against the JAX package's (``_build_eval``) under +G, fixed and sampled
GTR. 7 taxa x 80 sites."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import JaxDraws, jax_mcmc_step, near_tie_accepts, random_children, record_accepts
from test_torch_mcmc import CASES, GTR, data  # noqa: F401

import trex_tpu.search.mcmc as jax_mcmc
from trex_tpu_torch.search import mcmc


def test_port_resumes_a_jax_checkpoint(tmp_path, data, monkeypatch):  # noqa: F811
    kw, gens, seed = CASES["informed_jc"]
    patterns, weights = data
    common = dict(n_generations=gens, sample_every=10, burnin_frac=0.25,
                  sequences_are_masks=True, checkpoint_every=10**6, **kw)
    jax_dir, port_dir, whole_dir = (str(tmp_path / d) for d in ("jax", "port", "whole"))
    jax_mcmc.mcmc_sample(jax.random.PRNGKey(seed), jnp.asarray(patterns), 4,
                         site_weights=jnp.asarray(weights), checkpoint_dir=jax_dir,
                         stop_after_generations=10, **common)
    leg = dict(np.load(os.path.join(jax_dir, "mcmc_checkpoint.npz")))
    assert int(leg["gens_done"]) == 10
    state = mcmc.McmcState.from_numpy(leg, "cpu")
    for key, value in state.to_numpy().items():
        np.testing.assert_array_equal(value, leg[key], err_msg=key)
    os.makedirs(port_dir)
    np.savez(os.path.join(port_dir, "mcmc_checkpoint.npz"), draws_state=leg.pop("jax_key"),
             **leg)
    step = jax_mcmc_step(2, False, "informed", True)
    margins = record_accepts(monkeypatch)
    resumed = mcmc.mcmc_sample(patterns, 4, seed=seed, draws=JaxDraws(None, step),
                               device="cpu", site_weights=weights, checkpoint_dir=port_dir,
                               **common)
    whole = mcmc.mcmc_sample(patterns, 4, seed=seed,
                             draws=JaxDraws(jax.random.PRNGKey(seed), step), device="cpu",
                             site_weights=weights, checkpoint_dir=whole_dir, **common)
    got, want = (np.load(os.path.join(d, "mcmc_checkpoint.npz")) for d in (port_dir, whole_dir))
    assert near_tie_accepts(margins, float(np.abs(got["lnl"]).max())) == 0
    for key in ("children", "acc", "s_children", "s_run", "gens_done", "draws_state"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for key in ("lengths", "lnl", "s_lengths", "s_lnl"):
        np.testing.assert_allclose(got[key], want[key], rtol=2e-5, atol=1e-6, err_msg=key)
    assert resumed.consensus_newick == whole.consensus_newick
    assert resumed.acceptance == whole.acceptance


@pytest.mark.parametrize("sample_model", [False, True])
def test_gamma_evaluator_equals_jax(data, sample_model):  # noqa: F811
    """K4's per-site mode on chains x categories trees (the plain version
    here), a logsumexp over categories: within rtol 2e-5 of the JAX
    package's lax evaluator."""
    patterns, weights = data
    rng = np.random.default_rng(8)
    n = patterns.shape[0]
    children = random_children(rng, n, 3)
    lengths = rng.exponential(0.1, (3, 2 * n - 1)).astype(np.float32)
    rates_v = rng.dirichlet(np.ones(6), 3).astype(np.float32)
    freqs_v = rng.dirichlet(np.ones(4) * 5, 3).astype(np.float32)
    model = dict(rates=None, freqs=None) if sample_model else dict(rates=GTR[0], freqs=GTR[1])
    port_eval, port_nbr = mcmc._build_eval(
        torch.as_tensor(patterns), 4, torch.as_tensor(weights), True, model["rates"],
        model["freqs"], 0.6, 4, sample_model)
    jax_eval, _ = jax_mcmc._build_eval(
        jnp.asarray(patterns), 4, 2 * n - 1, jnp.asarray(weights), True,
        None if model["rates"] is None else jnp.asarray(model["rates"]),
        None if model["freqs"] is None else jnp.asarray(model["freqs"]), 0.6, 4,
        force_lax=True, sample_model=sample_model)
    args = (children, lengths, rates_v, freqs_v)
    got = port_eval(*(torch.as_tensor(x) for x in args))
    want = jax.jit(jax_eval)(*(jnp.asarray(x) for x in args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5)
    assert port_nbr is None
