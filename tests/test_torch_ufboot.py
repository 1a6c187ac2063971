"""Ultrafast bootstrap (``search/ufboot.py``) against the JAX package on the
same numpy inputs, the same explicit candidates and the JAX package's
replicate draws; ``default_candidates`` against the JAX package with both
reading the port's build of the native move library. Shapes: 8 taxa x 60
patterns, 3 Newton sweeps, 200 replicates."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import (
    evolved_masks,
    integer_weights,
    near_tie_replicates,
    parents_of,
    random_children,
    share_native_library,
)

import trex_tpu.search.bootstrap as jax_bootstrap
import trex_tpu.search.ufboot as jax_ufboot
from trex_tpu.topology import Topology as JaxTopology
from trex_tpu_torch.io import nni_neighbors_host
from trex_tpu_torch.ops.likelihood_asr import per_site_matrix
from trex_tpu_torch.search import ufboot
from trex_tpu_torch.topology import from_numpy

N_TAXA, N_SITES, SWEEPS, REPLICATES = 8, 60, 3, 200


def _jax(children, parents):
    return JaxTopology(children=jnp.asarray(children), parents=jnp.asarray(parents))


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(3)
    children = random_children(rng, N_TAXA, 1)[0]
    parents = parents_of(children)
    masks = evolved_masks(rng, children, N_SITES, 0.2)
    weights = integer_weights(rng, N_SITES)
    nni_children, nni_parents = nni_neighbors_host(from_numpy(children, parents))
    others = random_children(rng, N_TAXA, 3)
    # Reference, 11 NNI neighbours, 3 random trees: the reference third.
    cand_children = np.concatenate([nni_children[:2], children[None], nni_children[2:11],
                                    others])
    cand_parents = np.concatenate([nni_parents[:2], parents[None], nni_parents[2:11],
                                   parents_of(others)])
    key = jax.random.PRNGKey(11)
    args = dict(site_weights=jnp.asarray(weights), n_replicates=REPLICATES, n_sweeps=SWEEPS,
                sequences_are_masks=True)
    want = jax_ufboot.ultrafast_bootstrap(
        key, _jax(children, parents), jnp.asarray(masks), 4,
        candidates=_jax(cand_children, cand_parents), **args)
    # Candidates without the reference: it is put first.
    want_prepended = jax_ufboot.ultrafast_bootstrap(
        key, _jax(children, parents), jnp.asarray(masks), 4,
        candidates=_jax(cand_children[3:], cand_parents[3:]), **args)
    draws = np.array(jax_bootstrap._replicate_weights(key, N_SITES, REPLICATES,
                                                      jnp.asarray(weights)))
    return dict(children=children, parents=parents, masks=masks, weights=weights,
                cand_children=cand_children, cand_parents=cand_parents, want=want,
                want_prepended=want_prepended, draws=draws)


@pytest.mark.parametrize("drop", [0, 3])
def test_ultrafast_bootstrap_matches_jax(case, drop):
    want = case["want_prepended"] if drop else case["want"]
    got = ufboot.ultrafast_bootstrap(
        from_numpy(case["children"], case["parents"]), torch.as_tensor(case["masks"]), 4,
        candidates=from_numpy(case["cand_children"][drop:], case["cand_parents"][drop:]),
        site_weights=torch.as_tensor(case["weights"]), n_sweeps=SWEEPS,
        sequences_are_masks=True, replicate_weights=case["draws"])
    assert got.n_candidates == want.n_candidates
    assert got.reference_index == want.reference_index == (0 if drop else 2)
    np.testing.assert_allclose(got.log_likelihoods, want.log_likelihoods, rtol=2e-5)
    # A replicate whose top two RELL totals lie within 1e-5 relative may
    # vote the other way: allow that many votes.
    children = case["cand_children"][drop:]
    parents = case["cand_parents"][drop:]
    if drop:
        children = np.concatenate([case["children"][None], children])
        parents = np.concatenate([case["parents"][None], parents])
    rows = per_site_matrix(from_numpy(children, parents), torch.as_tensor(case["masks"]), 4,
                           weights=torch.as_tensor(case["weights"]), n_sweeps=SWEEPS,
                           sequences_are_masks=True).numpy()
    ties = near_tie_replicates(case["draws"].astype(np.float64) @ rows.T.astype(np.float64))
    print(f"near-tied replicates: {ties}")
    assert ties == 0
    np.testing.assert_array_equal(got.winner_counts, want.winner_counts)
    np.testing.assert_array_equal(got.support, want.support)


def test_unrooted_splits_match_jax(case):
    """The port's split bitmasks (bit i: leaf i) are the JAX package's leaf
    sets."""
    for children, parents in zip(case["cand_children"], case["cand_parents"], strict=True):
        want = jax_ufboot._unrooted_bipartitions(_jax(children, parents))
        assert ufboot._unrooted_split_masks(children) == {
            sum(1 << i for i in side) for side in want}


@pytest.fixture
def shared_native(monkeypatch):
    from trex_tpu.io import native as jax_native

    if not share_native_library(monkeypatch):
        pytest.skip("no C++ compiler: the native move library cannot be built")
    yield
    jax_native.load_library.cache_clear()


@pytest.mark.parametrize("extra_tbr, seed", [(0, 0), (16, 11)])
def test_default_candidates_match_jax(case, shared_native, extra_tbr, seed):
    got = ufboot.default_candidates(from_numpy(case["children"], case["parents"]),
                                    extra_tbr=extra_tbr, seed=seed)
    want = jax_ufboot.default_candidates(_jax(case["children"], case["parents"]),
                                         extra_tbr=extra_tbr, seed=seed)
    np.testing.assert_array_equal(got.children.numpy(), np.asarray(want.children))
    np.testing.assert_array_equal(got.parents.numpy(), np.asarray(want.parents))
    np.testing.assert_array_equal(got.children[0].numpy(), case["children"])


def test_ultrafast_bootstrap_needs_draws(case):
    with pytest.raises(ValueError, match="replicate_weights or a generator"):
        ufboot.ultrafast_bootstrap(
            from_numpy(case["children"], case["parents"]), torch.as_tensor(case["masks"]), 4,
            candidates=from_numpy(case["cand_children"][:3], case["cand_parents"][:3]),
            n_sweeps=1, sequences_are_masks=True)
