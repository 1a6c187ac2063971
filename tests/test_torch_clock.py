"""The clock (``ops/clock.py``) and the coalescent area against the JAX
package on the same numpy inputs: ``coalescent_area``, ``ages_to_lengths``
and ``increments_to_ages`` equal (the area within 1e-6), ``optimize_clock``
and ``clock_lrt`` at 30 Adam steps within the fits' tolerances (losses
rtol 1e-5 for 20 steps, 1e-4 after; ages 1e-2). 7 taxa x 120 sites."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_dating import N_TAXA, case  # noqa: F401

import trex_tpu.ops.clock as jax_clock
import trex_tpu.search.dating as jax_dating
from trex_tpu_torch.ops import clock
from trex_tpu_torch.search import dating


def test_clock_helpers_equal_jax(case):  # noqa: F811
    rng = np.random.default_rng(5)
    ages = np.concatenate([rng.uniform(0, 0.05, (3, N_TAXA)),
                           rng.uniform(0.1, 0.5, (3, N_TAXA - 1))], axis=1).astype(np.float32)
    got = dating.coalescent_area(torch.as_tensor(ages), N_TAXA).numpy()
    want = [float(jax_dating.coalescent_area(jnp.asarray(a), N_TAXA)) for a in ages]
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_array_equal(
        clock.ages_to_lengths(case["topo"], torch.as_tensor(case["ages"])).numpy(),
        np.asarray(jax_clock.ages_to_lengths(case["jax_topo"], jnp.asarray(case["ages"]))))
    inc = rng.uniform(0.01, 0.1, N_TAXA - 1).astype(np.float32)
    np.testing.assert_array_equal(
        clock.increments_to_ages(case["topo"], torch.as_tensor(inc)).numpy(),
        np.asarray(jax_clock.increments_to_ages(case["jax_topo"], jnp.asarray(inc))))


def test_clock_fit_and_lrt_match_jax(case):  # noqa: F811
    kw = dict(sequences_are_masks=True, n_iterations=30)
    ages, losses = clock.optimize_clock(case["topo"], torch.as_tensor(case["patterns"]), 4,
                                        site_weights=torch.as_tensor(case["weights"]), **kw)
    j_ages, j_losses = jax_clock.optimize_clock(
        case["jax_topo"], jnp.asarray(case["patterns"]), 4,
        site_weights=jnp.asarray(case["weights"]), **kw)
    np.testing.assert_allclose(losses.numpy()[:20], np.asarray(j_losses)[:20], rtol=1e-5)
    np.testing.assert_allclose(losses.numpy(), np.asarray(j_losses), rtol=1e-4)
    np.testing.assert_allclose(ages.numpy(), np.asarray(j_ages), rtol=1e-2, atol=1e-4)
    got = clock.clock_lrt(case["topo"], torch.as_tensor(case["patterns"]), 4,
                          site_weights=torch.as_tensor(case["weights"]), **kw)
    want = jax_clock.clock_lrt(case["jax_topo"], jnp.asarray(case["patterns"]), 4,
                               site_weights=jnp.asarray(case["weights"]), **kw)
    assert got["df"] == want["df"] == N_TAXA - 2
    for key in ("lnl_clock", "lnl_free"):
        assert got[key] == pytest.approx(want[key], rel=1e-4)
    assert got["statistic"] == pytest.approx(want["statistic"], abs=2e-4 * abs(want["lnl_free"]))
    assert 0.0 <= got["p_value"] <= 1.0
    np.testing.assert_allclose(got["ages"], want["ages"], rtol=1e-2, atol=1e-4)
