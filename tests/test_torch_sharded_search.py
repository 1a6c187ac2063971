"""The search paths wired to the mesh, on two CPU ranks (gloo) and the (2, 1)
and (1, 2) meshes of one world, against the JAX package's single-device
runs on the same numpy inputs and draws: the parsimony climbs (NNI and the
SPR scan), the ratchet, the bootstrap and SPR-decay (topologies, scores,
rounds, evaluations and supports equal), and the ML scan climb and ML
bootstrap (the same topologies and rounds, lnL within rtol 2e-5). 10 taxa
x 61 patterns (odd: the site shards pad)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from _torch_dist import MESHES, start_ranks
from _torch_parity import evolved_masks, integer_weights, parents_of, random_children

import trex_tpu.ops.dispatch as jax_dispatch
import trex_tpu.ops.likelihood as jax_likelihood
import trex_tpu.search.ml as jax_ml
from trex_tpu.search import bootstrap as jax_bootstrap
from trex_tpu.search import ratchet as jax_ratchet
from trex_tpu.search.bremer import spr_decay_support as jax_decay
from trex_tpu.search.hillclimb import parsimony_hill_climb as jax_climb
from trex_tpu.topology import Topology as JaxTopology
from trex_tpu.types import CostModel

N_TAXA, N_SITES, SEED = 10, 61, 9


def _upweighted(seed: int, n_iterations: int) -> np.ndarray:
    """The JAX ratchet's Bernoulli draws for ``PRNGKey(seed)``."""
    key, rows = jax.random.PRNGKey(seed), []
    for _ in range(n_iterations):
        key, perturb_key = jax.random.split(key)
        rows.append(np.asarray(jax.random.bernoulli(perturb_key, 0.25, (N_SITES,))))
    return np.stack(rows)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    rng = np.random.default_rng(7)
    masks = evolved_masks(rng, random_children(rng, N_TAXA, 1)[0], N_SITES, 0.3)
    masks[rng.random(masks.shape) < 0.04] = 15  # missing data
    start = random_children(rng, N_TAXA, 1)[0]
    weights = integer_weights(rng, N_SITES)
    key = jax.random.PRNGKey(SEED)
    replicates = np.array(jax_bootstrap._replicate_weights(key, N_SITES, 3,
                                                           jnp.asarray(weights)))
    inputs = dict(start_children=start, start_parents=parents_of(start), masks=masks,
                  weights=weights, upweighted=_upweighted(3, 2), replicates=replicates)
    ranks = start_ranks(tmp_path_factory.mktemp("search"), "search", inputs)
    with pytest.MonkeyPatch.context() as mp:
        want = _oracle(inputs, key, mp)
    return want, ranks.wait()


def _oracle(inputs, key, mp):
    """The JAX package's single-device runs, its scorers jitted (the same
    functions, compiled whole)."""
    from trex_tpu.ops.fitch import fitch_score

    @jax.jit
    def fitch(topos, leaves, w):
        return jax.vmap(lambda t: fitch_score(t, leaves, site_mask=w,
                                              sequences_are_masks=True))(topos)

    def scores(topos, cost, leaves, site_weights=None, *, sequences_are_masks=False):
        return fitch(topos, leaves, site_weights)

    fast = jax.jit(jax_likelihood.tree_log_likelihood, static_argnums=(3,),
                   static_argnames=("sequences_are_masks",))
    mp.setattr(jax_dispatch, "batched_scores_fastest", scores)
    mp.setattr(jax_likelihood, "tree_log_likelihood", fast)
    mp.setattr(jax_ml, "tree_log_likelihood", fast)

    start = JaxTopology(jnp.asarray(inputs["start_children"]),
                        jnp.asarray(inputs["start_parents"]))
    masks, w = jnp.asarray(inputs["masks"]), jnp.asarray(inputs["weights"])
    cost = CostModel.hamming(4).matrix
    kw = dict(site_weights=w, sequences_are_masks=True)
    want = {
        "nni": jax_climb(start, cost, masks, max_rounds=6, neighborhood="nni",
                         score_batch_fn=lambda t, c, leaves: scores(t, c, leaves, w)),
        "spr-scan": jax_climb(start, cost, masks, max_rounds=6, neighborhood="spr-scan", **kw),
        "ratchet": jax_ratchet.parsimony_ratchet(
            jax.random.PRNGKey(3), start, cost, masks, n_iterations=2, climb_rounds=4,
            neighborhood="nni", **kw),
        "bootstrap": jax_bootstrap.bootstrap_analysis(
            key, start, cost, masks, n_replicates=3, search_rounds=3, **kw),
        "decay": jax_decay(start, masks, w, sequences_are_masks=True),
        "ml": jax_ml.ml_hill_climb(start, masks, 4, neighborhood="spr-scan", max_rounds=4,
                                   **kw),
        "ml_bootstrap": jax_bootstrap.ml_bootstrap_analysis(
            key, start, masks, 4, n_replicates=3, search_rounds=3, **kw),
    }
    return want


def _same_result(out, name, want, rtol=0.0):
    np.testing.assert_array_equal(out[f"{name}_children"], np.asarray(want.topology.children))
    score, rounds, evaluations = out[f"{name}_numbers"]
    np.testing.assert_allclose(score, want.score, rtol=rtol)
    assert (rounds, evaluations) == (want.rounds, want.evaluations)
    np.testing.assert_allclose(out[f"{name}_trace"], want.trace, rtol=rtol)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("name", ["nni", "spr-scan", "ratchet"])
def test_parsimony_climbs_equal_jax(case, mesh, name):
    want, outs = case
    assert want[name].rounds > 0
    for out in outs:
        _same_result(out, f"{mesh}_{name}", want[name])


@pytest.mark.parametrize("mesh", MESHES)
def test_bootstrap_equals_jax(case, mesh):
    want, outs = case
    support, trees = want["bootstrap"]
    for out in outs:
        np.testing.assert_array_equal(out[f"{mesh}_bootstrap"], support)
        np.testing.assert_array_equal(out[f"{mesh}_bootstrap_trees"],
                                      np.stack([np.asarray(t.children) for t in trees]))


@pytest.mark.parametrize("mesh", MESHES)
def test_decay_equals_jax(case, mesh):
    want, outs = case
    decay, base = want["decay"]
    for out in outs:
        np.testing.assert_array_equal(out[f"{mesh}_decay"], decay)
        assert float(out[f"{mesh}_decay_base"]) == base


@pytest.mark.parametrize("mesh", MESHES)
def test_ml_scan_climb_matches_jax(case, mesh):
    want, outs = case
    result, lengths, losses = want["ml"]
    assert result.rounds > 0
    for out in outs:
        _same_result(out, f"{mesh}_ml", result, rtol=2e-5)
        np.testing.assert_allclose(out[f"{mesh}_ml_losses"][-1], np.asarray(losses)[-1],
                                   rtol=2e-5)
        np.testing.assert_allclose(out[f"{mesh}_ml_lengths"], np.asarray(lengths), atol=1e-3)


@pytest.mark.parametrize("mesh", MESHES)
def test_ml_bootstrap_equals_jax(case, mesh):
    want, outs = case
    support, trees = want["ml_bootstrap"]
    for out in outs:
        np.testing.assert_array_equal(out[f"{mesh}_ml_bootstrap"], support)
        np.testing.assert_array_equal(out[f"{mesh}_ml_bootstrap_trees"],
                                      np.stack([np.asarray(t.children) for t in trees]))
