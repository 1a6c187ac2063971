"""Host tree tools against the JAX package on the same numpy trees:
consensus (``search/consensus.py``), length-aware tree distances
(``search/treedist.py``), gene and site concordance factors
(``search/concordance.py``; the sCF quartets drawn from the same numpy
seed) and ``io.format_tree``. Splits, newick strings, quartets and
concordance values exactly; distances within 1e-12."""

import jax.numpy as jnp
import numpy as np
import pytest
from _torch_parity import evolved_masks, parents_of, random_children

import trex_tpu.io as jax_io
import trex_tpu.search.concordance as jax_concordance
import trex_tpu.search.consensus as jax_consensus
import trex_tpu.search.treedist as jax_treedist
from trex_tpu.topology import Topology as JaxTopology
from trex_tpu_torch import io as tio
from trex_tpu_torch.search import concordance, consensus, treedist
from trex_tpu_torch.topology import from_numpy

N_TAXA = 9


def _pair(children):
    parents = parents_of(children)
    return (from_numpy(children, parents),
            JaxTopology(children=jnp.asarray(children), parents=jnp.asarray(parents)))


@pytest.fixture(scope="module")
def trees():
    """A reference tree, 12 'replicates' around it (its NNI neighbours and
    itself) and 3 random trees, each as (port, JAX) topologies."""
    rng = np.random.default_rng(8)
    ref = random_children(rng, N_TAXA, 1)[0]
    neighbours, _ = tio.nni_neighbors_host(from_numpy(ref, parents_of(ref)))
    reps = [ref] * 4 + list(neighbours[:8]) + list(random_children(rng, N_TAXA, 3))
    return [_pair(ref)] + [_pair(np.asarray(c)) for c in reps]


@pytest.mark.parametrize("threshold", [0.5, 0.3, 0.8])
def test_consensus_matches_jax(trees, threshold):
    ours = [t for t, _ in trees]
    theirs = [t for _, t in trees]
    assert consensus.split_frequencies(ours) == jax_consensus.split_frequencies(theirs)
    names = [f"t{i}" for i in range(N_TAXA)]
    assert consensus.majority_rule_consensus(ours, names, threshold) == \
        jax_consensus.majority_rule_consensus(theirs, names, threshold)
    got = consensus.consensus_topology(ours, threshold)
    want = jax_consensus.consensus_topology(theirs, threshold)
    assert (got is None) == (want is None)
    if got is not None:
        np.testing.assert_array_equal(got.children.numpy(), np.asarray(want.children))
        np.testing.assert_array_equal(got.parents.numpy(), np.asarray(want.parents))


def test_resolved_consensus_topology(trees):
    """Identical replicates: the consensus is the tree itself."""
    ours = [trees[0][0]] * 3
    got = consensus.consensus_topology(ours)
    want = jax_consensus.consensus_topology([trees[0][1]] * 3)
    np.testing.assert_array_equal(got.children.numpy(), np.asarray(want.children))


def test_tree_distances_match_jax(trees):
    rng = np.random.default_rng(9)
    n_all = 2 * N_TAXA - 1
    for (a, ja), (b, jb) in zip(trees[:-1], trees[1:]):
        la = rng.uniform(0.01, 0.5, n_all)
        lb = rng.uniform(0.01, 0.5, n_all)
        np.testing.assert_allclose(treedist.patristic_matrix(a, la),
                                   jax_treedist.patristic_matrix(ja, la), rtol=0, atol=1e-12)
        for name in ("branch_score_distance", "weighted_rf_distance",
                     "path_difference_distance"):
            got = getattr(treedist, name)(a, la, b, lb)
            want = getattr(jax_treedist, name)(ja, la, jb, lb)
            assert abs(got - want) <= 1e-12, name
        assert treedist._split_lengths(a, la) == jax_treedist._split_lengths(ja, la)


def test_concordance_matches_jax(trees):
    ref, jref = trees[0]
    genes = [t for t, _ in trees[1:]]
    jgenes = [t for _, t in trees[1:]]
    rng = np.random.default_rng(10)
    masks = evolved_masks(rng, np.asarray(jref.children), 80, 0.2)
    masks[rng.random(masks.shape) < 0.05] = 15  # missing: not decisive
    weights = rng.integers(1, 4, 80).astype(np.float64)
    assert concordance._internal_branches(ref) == jax_concordance._internal_branches(jref)
    np.testing.assert_array_equal(
        np.stack(concordance.gene_concordance(ref, genes)),
        np.stack(jax_concordance.gene_concordance(jref, jgenes)))
    for seed, w in ((0, None), (3, weights)):
        got = concordance.site_concordance(ref, masks, n_quartets=40, seed=seed,
                                           sequences_are_masks=True, site_weights=w)
        want = jax_concordance.site_concordance(jref, masks, n_quartets=40, seed=seed,
                                                sequences_are_masks=True, site_weights=w)
        np.testing.assert_array_equal(np.stack(got), np.stack(want))
    ints = np.log2(masks).astype(np.int32)
    ints[masks == 15] = -1
    got = concordance.concordance_factors(ref, genes, ints, n_quartets=20, seed=1)
    want = jax_concordance.concordance_factors(jref, jgenes, ints, n_quartets=20, seed=1)
    for field in ("gcf", "gcf_n", "scf", "scf_n"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field), err_msg=field)


def test_format_tree_matches_jax(trees):
    names = [f"taxon_{i}" for i in range(N_TAXA)]
    for topo, jtopo in trees[:4]:
        ann = {i: f":{0.1 * i:.4g}" for i in range(0, 2 * N_TAXA - 2, 3)}
        assert tio.format_tree(topo, names, ann) == jax_io.format_tree(jtopo, names, ann)
        assert tio.format_tree(topo) == jax_io.format_tree(jtopo)
