"""The likelihood supports wired to the mesh (``branch_supports``,
``ultrafast_bootstrap``, ``topology_tests`` with ``mesh=``: the candidates'
batched fits split over 'tree'), on two CPU ranks (gloo) and the (2, 1)
and (1, 2) meshes of one world, against the JAX package's single-device
runs on the same numpy inputs and the JAX package's draws. The cases are
those of ``test_torch_alrt.py``, ``test_torch_ufboot.py`` and
``test_torch_topotest.py`` (8 taxa x 60 patterns, 3 Newton sweeps, 200
replicates; no AU scales), whose replicates hold no near tie (top two RELL
totals within 1e-5 relative), so the votes are JAX's exactly and the
likelihoods within rtol 2e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from _torch_dist import MESHES, start_ranks
from _torch_parity import (
    evolved_masks,
    integer_weights,
    parents_of,
    random_children,
)

import trex_tpu.search.alrt as jax_alrt
import trex_tpu.search.bootstrap as jax_bootstrap
import trex_tpu.search.topotest as jax_topotest
import trex_tpu.search.ufboot as jax_ufboot
from trex_tpu.topology import Topology as JaxTopology
from trex_tpu_torch.io import nni_neighbors_host
from trex_tpu_torch.search.ufboot import _unrooted_split_masks
from trex_tpu_torch.topology import from_numpy

N_TAXA, N_SITES, SWEEPS, REPLICATES = 8, 60, 3, 200


def _jax(children, parents):
    return JaxTopology(children=jnp.asarray(children), parents=jnp.asarray(parents))


def _draws(key, weights):
    return np.array(jax_bootstrap._replicate_weights(key, N_SITES, REPLICATES,
                                                     jnp.asarray(weights)))


def _alrt_case(inputs, want):
    rng = np.random.default_rng(2)
    children = random_children(rng, N_TAXA, 1)[0]
    masks = evolved_masks(rng, children, N_SITES, 0.15)
    masks[rng.random(masks.shape) < 0.05] = 15
    weights = integer_weights(rng, N_SITES)
    key = jax.random.PRNGKey(7)
    inputs.update(alrt_children=children, alrt_parents=parents_of(children), alrt_masks=masks,
                  alrt_weights=weights, alrt_draws=_draws(key, weights))
    return lambda: want.update(alrt=jax_alrt.branch_supports(
        key, _jax(children, parents_of(children)), jnp.asarray(masks), 4,
        site_weights=jnp.asarray(weights), n_replicates=REPLICATES, n_sweeps=SWEEPS,
        sequences_are_masks=True))


def _ufboot_case(inputs, want):
    rng = np.random.default_rng(3)
    children = random_children(rng, N_TAXA, 1)[0]
    parents = parents_of(children)
    masks = evolved_masks(rng, children, N_SITES, 0.2)
    weights = integer_weights(rng, N_SITES)
    nni_children, nni_parents = nni_neighbors_host(from_numpy(children, parents))
    others = random_children(rng, N_TAXA, 3)
    cand_children = np.concatenate([nni_children[:2], children[None], nni_children[2:11],
                                    others])
    cand_parents = np.concatenate([nni_parents[:2], parents[None], nni_parents[2:11],
                                   parents_of(others)])
    key = jax.random.PRNGKey(11)
    inputs.update(ub_children=children, ub_parents=parents, ub_masks=masks, ub_weights=weights,
                  ub_cand_children=cand_children, ub_cand_parents=cand_parents,
                  ub_draws=_draws(key, weights))
    return lambda: want.update(ub=jax_ufboot.ultrafast_bootstrap(
        key, _jax(children, parents), jnp.asarray(masks), 4,
        candidates=_jax(cand_children, cand_parents), site_weights=jnp.asarray(weights),
        n_replicates=REPLICATES, n_sweeps=SWEEPS, sequences_are_masks=True))


def _topotest_case(inputs, want):
    rng = np.random.default_rng(5)
    children = random_children(rng, N_TAXA, 1)[0]
    parents = parents_of(children)
    masks = evolved_masks(rng, children, N_SITES, 0.2)
    masks[rng.random(masks.shape) < 0.05] = 5
    weights = integer_weights(rng, N_SITES)
    nni_children, nni_parents = nni_neighbors_host(from_numpy(children, parents))
    other = random_children(rng, N_TAXA, 1)
    pool_children = np.concatenate([children[None], nni_children, other])
    pool_parents = np.concatenate([parents[None], nni_parents, parents_of(other)])
    seen, keep = set(), []
    for i in range(pool_children.shape[0]):
        sig = frozenset(_unrooted_split_masks(pool_children[i]))
        if sig not in seen and (len(keep) < 8 or i == pool_children.shape[0] - 1):
            seen.add(sig)
            keep.append(i)
    trees_children, trees_parents = pool_children[keep], pool_parents[keep]
    key = jax.random.PRNGKey(0)
    inputs.update(tt_children=trees_children, tt_parents=trees_parents, tt_masks=masks,
                  tt_weights=weights, tt_draws=_draws(key, weights))
    return lambda: want.update(tt=jax_topotest.topology_tests(
        key, _jax(trees_children, trees_parents), jnp.asarray(masks), 4,
        site_weights=jnp.asarray(weights), n_replicates=REPLICATES, n_sweeps=SWEEPS,
        sequences_are_masks=True, au_scales=None))


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    inputs, want = {}, {}
    oracles = [make(inputs, want) for make in (_alrt_case, _ufboot_case, _topotest_case)]
    ranks = start_ranks(tmp_path_factory.mktemp("supports"), "supports", inputs)
    for run in oracles:
        run()
    return want, ranks.wait()


@pytest.mark.parametrize("mesh", MESHES)
def test_branch_supports_equal_jax(case, mesh):
    want, outs = case
    want = want["alrt"]
    tested = ~np.isnan(want.alrt)
    for out in outs:
        assert abs(float(out[f"{mesh}_alrt_ll"]) - want.log_likelihood) <= \
            2e-5 * abs(want.log_likelihood)
        np.testing.assert_array_equal(np.isnan(out[f"{mesh}_alrt"]), ~tested)
        np.testing.assert_allclose(out[f"{mesh}_alrt"][tested], want.alrt[tested], atol=1e-2)
        np.testing.assert_array_equal(out[f"{mesh}_sh"], want.sh_alrt)
        np.testing.assert_array_equal(out[f"{mesh}_rell"], want.rell)


@pytest.mark.parametrize("mesh", MESHES)
def test_ultrafast_bootstrap_equals_jax(case, mesh):
    want, outs = case
    want = want["ub"]
    for out in outs:
        np.testing.assert_allclose(out[f"{mesh}_ub_ll"], want.log_likelihoods, rtol=2e-5)
        np.testing.assert_array_equal(out[f"{mesh}_ub_wins"], want.winner_counts)
        np.testing.assert_array_equal(out[f"{mesh}_ub_support"], want.support)


@pytest.mark.parametrize("mesh", MESHES)
def test_topology_tests_equal_jax(case, mesh):
    want, outs = case
    tt = want["tt"]
    for out in outs:
        assert int(out[f"{mesh}_tt_best_index"]) == tt.best_index
        np.testing.assert_allclose(out[f"{mesh}_tt_log_likelihoods"], tt.log_likelihoods,
                                   rtol=2e-5)
        np.testing.assert_allclose(out[f"{mesh}_tt_delta"], tt.delta, atol=1e-2)
        for key in ("bp", "p_kh", "p_sh"):
            np.testing.assert_allclose(out[f"{mesh}_tt_{key}"], getattr(tt, key), atol=1e-12)
        np.testing.assert_allclose(out[f"{mesh}_tt_elw"], tt.elw, atol=1e-4)
