"""The port's sampler with sampled GTR simplices (``mcmc_sample(...,
sample_model=True)``: Dirichlet moves, each chain's eigensystem, its
frequencies folded into K4's root child) and the uniform NNI proposal,
replayed against the JAX package's under its key schedule (see
``test_torch_mcmc.py``): same children, accepts, samples and key, lnL,
lengths and simplices within rtol 2e-5, no near-tied accept. 7 taxa x 80
sites, 20 generations of 1 run x 2 chains."""

import numpy as np
from test_torch_mcmc import assert_same_run, data, run_both  # noqa: F401


def test_replayed_full_bayes_trajectory_equals_jax(tmp_path, data, monkeypatch):  # noqa: F811
    want, got, margins, jax_ck, port_ck = run_both(tmp_path, data, "uniform_full_bayes",
                                                   monkeypatch)
    assert_same_run(want, got, jax_ck, port_ck, margins)
    assert port_ck["acc"][3] > 0
    np.testing.assert_allclose(got.sample_freqs, want.sample_freqs, rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(got.sample_rates, want.sample_rates, rtol=2e-5, atol=1e-6)
    assert set(got.acceptance) == set(want.acceptance) == {"branch", "topology", "swap", "model"}
