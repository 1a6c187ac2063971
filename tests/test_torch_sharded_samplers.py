"""The MC^3 sampler with its chains over the mesh's 'tree' axis, on two CPU
ranks (gloo) of one world that builds the (2, 1) and (1, 2) meshes,
against the JAX package's single-device sampler under JAX's key.

The parent runs each case through the port on one device under JAX's key
schedule (``_torch_parity.JaxDraws``), recording every draw
(``RecordedDraws``); the ranks, which import no JAX, replay the recording
(``_torch_dist.ReplayDraws``) while the parent computes the JAX oracle.
Each meshed run holds the children, samples, accept counters, key state
and consensus exactly, lengths and lnL within rtol 2e-5, and equals the
port's single-device run bit for bit; no accept of the single-device runs
lies within 1e-6 |lnL| of its threshold (counted). This file: informed JC
at 1 run x 4 chains on (2, 1), where the MC^3 swap straddles the ranks,
also stopped at (2, 1) and resumed on one device, and stopped on one
device and resumed at (2, 1); the divisibility checks.
``test_torch_sharded_samplers_model.py``: sampled GTR simplices (the
Dirichlet moves) on both meshes; ``test_torch_sharded_samplers_dating.py``:
``mcmc_date`` and ``stepping_stone``. 7 taxa x 80 sites, 20 generations.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_dist import start_ranks
from _torch_parity import (
    JaxDraws,
    RecordedDraws,
    evolved_masks,
    jax_mcmc_step,
    near_tie_accepts,
    parents_of,
    random_children,
    record_accepts,
)

import trex_tpu.search.mcmc as jax_mcmc
from trex_tpu_torch.alignment import compress_alignment
from trex_tpu_torch.ops.clock import increments_to_ages
from trex_tpu_torch.search import dating, marginal, mcmc
from trex_tpu_torch.topology import from_numpy

N_TAXA, N_SITES, GENS, STOP = 7, 80, 20, 10
MCMC_COMMON = dict(n_generations=GENS, sample_every=5, burnin_frac=0.25,
                   checkpoint_every=10**6)
JC = dict(n_runs=1, n_chains=4, branch_moves_per_gen=1, topo_proposal="informed", seed=4)
MCMC_RESULT = ("sample_children", "sample_lengths", "sample_lnl", "sample_run",
               "consensus_newick", "ess_lnl", "mean_lengths")


def sampler_data() -> dict:
    """The alignment's patterns and weights, the tree it evolved down and
    that tree's node ages (for the dating)."""
    rng = np.random.default_rng(11)
    children = random_children(rng, N_TAXA, 1)[0]
    patterns, weights = compress_alignment(evolved_masks(rng, children, N_SITES, 0.12))
    parents = parents_of(children)
    topo = from_numpy(children, parents)
    ages = increments_to_ages(topo, torch.as_tensor(
        rng.uniform(0.02, 0.08, N_TAXA - 1).astype(np.float32))).numpy()
    return dict(leaves=patterns.astype(np.int32), weights=weights.astype(np.float32),
                tree_children=children, tree_parents=parents, ages=ages)


def port_common(data: dict) -> dict:
    return dict(site_weights=data["weights"], sequences_are_masks=True, device="cpu")


def mcmc_step(kw: dict):
    return jax_mcmc_step(kw["branch_moves_per_gen"], kw.get("sample_model", False),
                         kw["topo_proposal"], kw["n_chains"] > 1)


def checkpoint(directory) -> dict:
    with np.load(os.path.join(directory, "mcmc_checkpoint.npz")) as saved:
        return dict(saved)


def mcmc_out(res, ck: dict) -> dict:
    """A single-device run's result and checkpoint as the ranks return them."""
    out = {k: np.asarray(getattr(res, k)) for k in MCMC_RESULT}
    out["acceptance"] = np.array(list(res.acceptance.values()))
    out["asdsf"] = np.asarray(np.nan if res.asdsf is None else res.asdsf)
    out.update({f"ck_{k}": v for k, v in ck.items()})
    return out


def record_mcmc(root, data: dict, kw: dict, mp, legs=({},)):
    """The port's single-device run of ``mcmc_sample(**kw)`` under JAX's
    keys, leg by leg in one checkpoint directory: (its output as the ranks
    return theirs, the recorded draws, the accept margins, each stopped
    leg's checkpoint)."""
    kw = dict(kw)
    seed = kw.pop("seed")
    margins = record_accepts(mp)
    draws = RecordedDraws(JaxDraws(jax.random.PRNGKey(seed), mcmc_step(kw)))
    ck, stops = str(root / "one"), []
    for leg in legs:
        res = mcmc.mcmc_sample(data["leaves"], 4, seed=seed, draws=draws, checkpoint_dir=ck,
                               **MCMC_COMMON, **kw, **leg, **port_common(data))
        if leg:
            stops.append(checkpoint(ck))
    return mcmc_out(res, checkpoint(ck)), draws, margins, stops


def jax_mcmc_run(root, data: dict, kw: dict):
    """The JAX package's single-device run: (result, checkpoint)."""
    kw = dict(kw)
    seed = kw.pop("seed")
    ck = str(root / "jax")
    res = jax_mcmc.mcmc_sample(jax.random.PRNGKey(seed), jnp.asarray(data["leaves"]), 4,
                               site_weights=jnp.asarray(data["weights"]),
                               sequences_are_masks=True, checkpoint_dir=ck, **MCMC_COMMON, **kw)
    return res, checkpoint(ck)


def lnl_scale(one: dict) -> float:
    return float(np.abs(one["ck_lnl"]).max())


def rank_run(outs, name: str) -> dict:
    """Run ``name``'s outputs, the same on both ranks."""
    got = [{k[len(name) + 1:]: v for k, v in out.items() if k.startswith(name + "_")}
           for out in outs]
    assert got[0].keys() == got[1].keys() and got[0]
    for key in got[0]:
        np.testing.assert_array_equal(got[1][key], got[0][key], err_msg=f"{name} {key}")
    return got[0]


def assert_mcmc_equals_jax(got: dict, want) -> None:
    res, jax_ck = want
    for key in ("children", "acc", "s_children", "s_run", "gens_done"):
        np.testing.assert_array_equal(got[f"ck_{key}"], jax_ck[key], err_msg=key)
    np.testing.assert_array_equal(got["ck_draws_state"], jax_ck["jax_key"])
    for key in ("lengths", "lnl", "s_lengths", "s_lnl", "rates", "freqs"):
        np.testing.assert_allclose(got[f"ck_{key}"], jax_ck[key], rtol=2e-5, atol=1e-6,
                                   err_msg=key)
    np.testing.assert_array_equal(got["sample_children"], res.sample_children)
    assert str(got["consensus_newick"]) == res.consensus_newick
    np.testing.assert_allclose(got["acceptance"], list(res.acceptance.values()), rtol=1e-12)
    np.testing.assert_allclose(got["sample_lnl"], res.sample_lnl, rtol=2e-5)


def assert_same(got: dict, one: dict, what: str) -> None:
    """Bit for bit the port's single-device run."""
    assert got.keys() == one.keys(), what
    for key in got:
        np.testing.assert_array_equal(got[key], one[key], err_msg=f"{what} {key}")


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    root = tmp_path_factory.mktemp("sharded_mcmc")
    data = sampler_data()
    with pytest.MonkeyPatch.context() as mp:
        one, draws, margins, (leg1,) = record_mcmc(
            root, data, JC, mp, legs=(dict(stop_after_generations=STOP), {}))
    run = dict(kind="mcmc", mesh="t2", draws="jc", kwargs=dict(MCMC_COMMON, **JC))
    runs = [dict(run, name="straddle", checkpoint="ck_straddle"),
            dict(run, name="leg1", checkpoint="ck_leg1",
                 kwargs=dict(run["kwargs"], stop_after_generations=STOP)),
            dict(run, name="from_one", checkpoint="ck_from_one", seed="leg1")]
    ranks = start_ranks(root, "samplers", dict(
        data, runs=runs, **draws.inputs("jc"), **{f"leg1_{k}": v for k, v in leg1.items()}))
    want = jax_mcmc_run(root, data, JC)
    outs = ranks.wait()

    # The checkpoint the ranks wrote at (2, 1), resumed on one device.
    resumed = root / "resumed"
    resumed.mkdir()
    np.savez(resumed / "mcmc_checkpoint.npz",
             **{k[len("leg1_ck_"):]: v for k, v in outs[0].items() if k.startswith("leg1_ck_")})
    kw = dict(JC)
    seed = kw.pop("seed")
    res = mcmc.mcmc_sample(data["leaves"], 4, seed=seed, draws=JaxDraws(None, mcmc_step(kw)),
                           checkpoint_dir=str(resumed), **MCMC_COMMON, **kw, **port_common(data))
    return dict(want=want, one=one, outs=outs, ties=near_tie_accepts(margins, lnl_scale(one)),
                resumed=mcmc_out(res, checkpoint(resumed)))


def test_single_device_replay_has_no_near_tie(case):
    assert case["ties"] == 0


def test_mcmc_with_straddling_swaps_equals_jax(case):
    """1 run x 4 chains on (2, 1): chains 0-1 on rank 0, 2-3 on rank 1, so
    every swap of chains 1 and 2 crosses the ranks."""
    got = rank_run(case["outs"], "straddle")
    assert_mcmc_equals_jax(got, case["want"])
    assert got["ck_acc"][2] > 0
    assert_same(got, case["one"], "straddle")


def test_checkpoint_resumes_across_meshes(case):
    """Stopped after 10 generations at (2, 1) and resumed on one device;
    stopped on one device and resumed at (2, 1): each ends where JAX's
    uninterrupted run ends."""
    leg1 = rank_run(case["outs"], "leg1")
    assert int(leg1["ck_gens_done"]) == STOP
    assert_mcmc_equals_jax(case["resumed"], case["want"])
    assert_same(case["resumed"], case["one"], "resumed on one device")
    got = rank_run(case["outs"], "from_one")
    assert_mcmc_equals_jax(got, case["want"])
    assert_same(got, case["one"], "resumed at (2, 1)")


def test_chains_must_divide_the_tree_axis():
    from trex_tpu_torch.parallel import make_mesh

    mesh = make_mesh(world_size=2, tree_parallelism=2)
    leaves = np.zeros((4, 8), np.int32)
    with pytest.raises(ValueError, match=r"n_runs \* n_chains = 3 must be divisible by the "
                                         r"mesh tree axis size \(2\)"):
        mcmc.mcmc_sample(leaves, 4, n_runs=1, n_chains=3, n_generations=2, device="cpu",
                         mesh=mesh)
    children = random_children(np.random.default_rng(0), 4, 1)[0]
    topo = from_numpy(children, parents_of(children))
    with pytest.raises(ValueError, match=r"n_rungs = 3 must be divisible"):
        marginal.stepping_stone(topo, leaves, 4, n_rungs=3, n_generations=2, device="cpu",
                                mesh=mesh)
    with pytest.raises(ValueError, match=r"n_chains = 3 must be divisible"):
        dating.mcmc_date(topo, leaves, 4, n_chains=3, n_generations=2, device="cpu",
                         mesh=mesh, start_ages=np.linspace(0, 1, 7, dtype=np.float32))
