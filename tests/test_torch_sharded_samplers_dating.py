"""``mcmc_date`` (4 chains, strict clock) and ``stepping_stone`` (4 rungs,
sampled GTR simplices) with their chains and rungs over the mesh's 'tree'
axis, on two CPU ranks (gloo) and the (2, 1) and (1, 2) meshes of one
world, replaying the draws of the port's single-device runs under JAX's
keys (as ``test_torch_sharded_samplers.py`` does): the same accepts, ages,
log ratios and lnL as the JAX package's single-device samplers, within
rtol 2e-5, and the port's single-device results bit for bit; no accept of
the single-device runs lies within 1e-6 |lnL| of its threshold (counted).
7 taxa x 80 sites, 20 generations (12 for the ladder)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from _torch_dist import MESHES, start_ranks
from _torch_parity import (
    JaxDraws,
    RecordedDraws,
    jax_dating_step,
    jax_marginal_step,
    near_tie_accepts,
    record_accepts,
)
from test_torch_sharded_samplers import GENS, port_common, rank_run, sampler_data

import trex_tpu.search.dating as jax_dating
import trex_tpu.search.marginal as jax_marginal
from trex_tpu.topology import Topology as JaxTopology
from trex_tpu_torch.search import dating, marginal
from trex_tpu_torch.topology import from_numpy

DATE = dict(n_generations=GENS, n_chains=4, sample_every=2)
DATE_SEED = 6
SS = dict(n_rungs=4, n_generations=12, sample_model=True)
SS_SEED = 7
DATE_FIELDS = ("sample_ages", "sample_lnl", "age_hpd", "ess_root_age")


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    data = sampler_data()
    topo = from_numpy(data["tree_children"], data["tree_parents"])
    common = port_common(data)
    with pytest.MonkeyPatch.context() as mp:
        date_margins = record_accepts(mp)
        date_draws = RecordedDraws(JaxDraws(*jax_dating_step(
            jax.random.PRNGKey(DATE_SEED), GENS, interior=True, relaxed=False, calibrated=False,
            heterochronous=False, sample_ne=False)))
        one_date = dating.mcmc_date(topo, data["leaves"], 4, seed=DATE_SEED, draws=date_draws,
                                    start_ages=data["ages"], **DATE, **common)
        ss_margins = record_accepts(mp)
        ss_draws = RecordedDraws(JaxDraws(*jax_marginal_step(
            jax.random.PRNGKey(SS_SEED), 2 * SS["n_generations"], True)))
        one_ss = marginal.stepping_stone(topo, data["leaves"], 4, seed=SS_SEED, draws=ss_draws,
                                         **SS, **common)
    runs = []
    for mesh in MESHES:
        runs += [dict(name=f"date_{mesh}", kind="date", mesh=mesh, draws="date",
                      kwargs=dict(DATE, seed=DATE_SEED)),
                 dict(name=f"ss_{mesh}", kind="ss", mesh=mesh, draws="ss",
                      kwargs=dict(SS, seed=SS_SEED))]
    ranks = start_ranks(tmp_path_factory.mktemp("sharded_dating"), "samplers", dict(
        data, runs=runs, **date_draws.inputs("date"), **ss_draws.inputs("ss")))

    jax_topo = JaxTopology(children=jnp.asarray(data["tree_children"]),
                           parents=jnp.asarray(data["tree_parents"]))
    jax_data = dict(site_weights=jnp.asarray(data["weights"]), sequences_are_masks=True)
    want_date = jax_dating.mcmc_date(jax.random.PRNGKey(DATE_SEED), jax_topo,
                                     jnp.asarray(data["leaves"]), 4, start_ages=data["ages"],
                                     **jax_data, **DATE)
    want_ss = jax_marginal.stepping_stone(jax.random.PRNGKey(SS_SEED), jax_topo,
                                          jnp.asarray(data["leaves"]), 4, **jax_data, **SS)
    ties = (near_tie_accepts(date_margins, float(np.abs(one_date.sample_lnl).max()))
            + near_tie_accepts(ss_margins, abs(one_ss["log_marginal"])))
    return dict(want=(want_date, want_ss), one=(one_date, one_ss), outs=ranks.wait(), ties=ties)


def test_single_device_replays_have_no_near_tie(case):
    assert case["ties"] == 0


@pytest.mark.parametrize("mesh", MESHES)
def test_dating_chains_over_the_mesh_equal_jax(case, mesh):
    got, want, one = rank_run(case["outs"], f"date_{mesh}"), case["want"][0], case["one"][0]
    np.testing.assert_array_equal(got["acceptance"], list(want.acceptance.values()))
    np.testing.assert_allclose(got["sample_ages"], want.sample_ages, rtol=2e-5, atol=1e-7)
    np.testing.assert_allclose(got["sample_lnl"], want.sample_lnl, rtol=2e-5)
    np.testing.assert_allclose(got["age_hpd"], want.age_hpd, rtol=2e-5, atol=1e-7)
    for key in DATE_FIELDS:
        np.testing.assert_array_equal(got[key], getattr(one, key), err_msg=key)
    np.testing.assert_array_equal(got["acceptance"], list(one.acceptance.values()))


@pytest.mark.parametrize("mesh", MESHES)
def test_stepping_stone_rungs_over_the_mesh_equal_jax(case, mesh):
    got, want, one = rank_run(case["outs"], f"ss_{mesh}"), case["want"][1], case["one"][1]
    assert float(got["acceptance"]) == want["acceptance"]
    np.testing.assert_allclose(got["log_ratios"], want["log_ratios"], rtol=2e-5, atol=1e-6)
    assert float(got["log_marginal"]) == pytest.approx(want["log_marginal"], rel=2e-5)
    for key, value in one.items():
        np.testing.assert_array_equal(got[key], value, err_msg=key)
