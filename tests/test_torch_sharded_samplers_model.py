"""The MC^3 sampler with sampled GTR simplices (the Dirichlet moves, whose
draws take the whole batch's concentrations) and the uniform NNI proposal,
2 runs x 2 chains over the mesh's 'tree' axis on two CPU ranks (gloo), on
the (2, 1) and (1, 2) meshes of one world, against the JAX package's
single-device sampler under JAX's key and the port's single-device run,
as ``test_torch_sharded_samplers.py`` holds the JC sampler. 7 taxa x 80
sites, 20 generations."""

import pytest
from _torch_dist import MESHES, start_ranks
from test_torch_sharded_samplers import (
    MCMC_COMMON,
    assert_mcmc_equals_jax,
    assert_same,
    jax_mcmc_run,
    lnl_scale,
    rank_run,
    record_mcmc,
    sampler_data,
)

from _torch_parity import near_tie_accepts

GTR = dict(n_runs=2, n_chains=2, branch_moves_per_gen=1, topo_proposal="nni",
           sample_model=True, seed=5)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    root = tmp_path_factory.mktemp("sharded_mcmc_model")
    data = sampler_data()
    with pytest.MonkeyPatch.context() as mp:
        one, draws, margins, _ = record_mcmc(root, data, GTR, mp)
    runs = [dict(name=mesh, kind="mcmc", mesh=mesh, draws="gtr", checkpoint=f"ck_{mesh}",
                 kwargs=dict(MCMC_COMMON, **GTR)) for mesh in MESHES]
    ranks = start_ranks(root, "samplers", dict(data, runs=runs, **draws.inputs("gtr")))
    want = jax_mcmc_run(root, data, GTR)
    return dict(want=want, one=one, outs=ranks.wait(),
                ties=near_tie_accepts(margins, lnl_scale(one)))


def test_single_device_replay_has_no_near_tie(case):
    assert case["ties"] == 0


@pytest.mark.parametrize("mesh", MESHES)
def test_mcmc_with_sampled_simplices_equals_jax(case, mesh):
    got = rank_run(case["outs"], mesh)
    assert_mcmc_equals_jax(got, case["want"])
    assert got["ck_acc"][3] > 0
    assert_same(got, case["one"], mesh)
