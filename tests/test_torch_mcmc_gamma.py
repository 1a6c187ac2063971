"""The informed proposal under a fixed GTR+G model, replayed against the
JAX package's sampler under its key schedule (see ``test_torch_mcmc.py``).
Under +G the port scores no neighbourhood by ``nni_scan``: it builds the
C x 2(n - 2) neighbour trees (``nni_neighborhood_device``), scores them
through K4's per-site mode on their categories and reads the pick back
out of the (C, 2(n - 2)) table, as the JAX package's fallback does. The
same children, accepts, samples and key, lnL and lengths within rtol
2e-5, no near-tied accept; ``test_torch_mcmc_gamma_model.py`` the same
with sampled GTR simplices. 7 taxa x 80 sites, 20 generations of 1 run x
2 chains."""

from test_torch_mcmc import assert_same_run, data, run_both  # noqa: F401


def test_replayed_informed_gamma_trajectory_equals_jax(tmp_path, data, monkeypatch):  # noqa: F811
    want, got, margins, jax_ck, port_ck = run_both(tmp_path, data, "informed_gtr_g",
                                                   monkeypatch)
    assert_same_run(want, got, jax_ck, port_ck, margins)
    assert port_ck["acc"][1] > 0
