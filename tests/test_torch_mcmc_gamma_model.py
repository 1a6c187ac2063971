"""The informed proposal under +G with sampled GTR simplices
(``sample_model=True``), replayed against the JAX package's sampler under
its key schedule (see ``test_torch_mcmc_gamma.py``: the neighbourhood's
trees scored through K4's per-site mode, each neighbour with its chain's
simplices). The same children, accepts, samples and key, lnL, lengths and
simplices within rtol 2e-5, no near-tied accept. 7 taxa x 80 sites, 20
generations of 1 run x 2 chains."""

import numpy as np
from test_torch_mcmc import assert_same_run, data, run_both  # noqa: F401


def test_replayed_informed_gamma_full_bayes_trajectory_equals_jax(tmp_path, data,  # noqa: F811
                                                                  monkeypatch):
    want, got, margins, jax_ck, port_ck = run_both(tmp_path, data, "informed_full_bayes_g",
                                                   monkeypatch)
    assert_same_run(want, got, jax_ck, port_ck, margins)
    assert port_ck["acc"][1] > 0 and port_ck["acc"][3] > 0
    np.testing.assert_allclose(got.sample_freqs, want.sample_freqs, rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(got.sample_rates, want.sample_rates, rtol=2e-5, atol=1e-6)
