"""The parsimony ratchet, the bootstrap, SPR-decay support, the segmented
SPR scans and the tree distances of ``trex_tpu_torch`` against
``trex_tpu``, with the JAX package's own draws replayed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import (
    integer_weights,
    jitted_jax_scores,
    parents_of,
    random_children,
    random_masks,
)

from trex_tpu.ops.spr_scan import spr_scan_best as jax_scan_best
from trex_tpu.ops.spr_scan import spr_scan_segmented as jax_scan_segmented
from trex_tpu.search import bootstrap as jax_bootstrap
from trex_tpu.search import ratchet as jax_ratchet
from trex_tpu.search.bremer import spr_decay_support as jax_decay
from trex_tpu.search.hillclimb import parsimony_hill_climb as jax_climb
from trex_tpu.topology import Topology as JaxTopology
from trex_tpu.types import CostModel as JaxCostModel
from trex_tpu_torch.ops.spr_scan import spr_scan_best, spr_scan_segmented
from trex_tpu_torch.search import bootstrap, ratchet
from trex_tpu_torch.search.bremer import spr_decay_support
from trex_tpu_torch.topology import from_numpy
from trex_tpu_torch.types import CostModel

N_LEAVES, LENGTH = 12, 48


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(41)
    children = random_children(rng, N_LEAVES, 1)[0]
    parents = parents_of(children)
    return (from_numpy(children, parents),
            JaxTopology(children=jnp.asarray(children), parents=jnp.asarray(parents)),
            random_masks(rng, N_LEAVES, LENGTH, ambiguity=0.2), integer_weights(rng, LENGTH))


@pytest.fixture
def jitted_scorers(monkeypatch):
    jitted_jax_scores(monkeypatch)


def _jax_upweighted(seed: int, n_iterations: int) -> np.ndarray:
    """The JAX ratchet's Bernoulli draws for ``PRNGKey(seed)``."""
    key = jax.random.PRNGKey(seed)
    rows = []
    for _ in range(n_iterations):
        key, perturb_key = jax.random.split(key)
        rows.append(np.asarray(jax.random.bernoulli(perturb_key, 0.25, (LENGTH,))))
    return np.stack(rows)


@pytest.mark.parametrize("neighborhood", ["spr-scan", "nni"])
def test_ratchet_on_jax_draws(data, jitted_scorers, neighborhood, tmp_path):
    topo, jax_topo, masks, weights = data
    ours = ratchet.parsimony_ratchet(
        topo, CostModel.hamming(4).matrix, masks, upweighted=_jax_upweighted(3, 3),
        n_iterations=3, climb_rounds=8, neighborhood=neighborhood, site_weights=weights,
        sequences_are_masks=True, progress_dir=str(tmp_path / "ours"), device="cpu",
    )
    ref = jax_ratchet.parsimony_ratchet(
        jax.random.PRNGKey(3), jax_topo, JaxCostModel.hamming(4).matrix, jnp.asarray(masks),
        n_iterations=3, climb_rounds=8, neighborhood=neighborhood,
        site_weights=jnp.asarray(weights), sequences_are_masks=True,
        progress_dir=str(tmp_path / "ref"),
    )
    np.testing.assert_array_equal(ours.topology.children.numpy(), np.asarray(ref.topology.children))
    assert (ours.score, ours.rounds, ours.evaluations, ours.trace) == (
        ref.score, ref.rounds, ref.evaluations, ref.trace)
    for name in ("best.nwk", "trace.jsonl"):
        assert (tmp_path / "ours" / name).read_text() == (tmp_path / "ref" / name).read_text()


def test_ratchet_draws_from_a_generator(data):
    topo, _, masks, weights = data
    runs = [
        ratchet.parsimony_ratchet(
            topo, CostModel.hamming(4).matrix, masks, generator=torch.Generator().manual_seed(5),
            n_iterations=2, climb_rounds=4, neighborhood="spr-scan", site_weights=weights,
            sequences_are_masks=True, device="cpu",
        )
        for _ in range(2)
    ]
    assert runs[0].trace == runs[1].trace and runs[0].rounds == 2
    with pytest.raises(ValueError, match="generator"):
        ratchet.parsimony_ratchet(topo, CostModel.hamming(4).matrix, masks, n_iterations=1,
                                  device="cpu")


def test_bootstrap_on_jax_weights(data, jitted_scorers):
    topo, jax_topo, masks, weights = data
    key = jax.random.PRNGKey(9)
    replicate_weights = np.array(jax_bootstrap._replicate_weights(key, LENGTH, 4, weights))
    support, best = bootstrap.bootstrap_analysis(
        topo, CostModel.hamming(4).matrix, masks, n_replicates=4, search_rounds=4,
        site_weights=weights, sequences_are_masks=True, replicate_weights=replicate_weights,
        device="cpu",
    )
    ref_support, ref_best = jax_bootstrap.bootstrap_analysis(
        key, jax_topo, JaxCostModel.hamming(4).matrix, jnp.asarray(masks), n_replicates=4,
        search_rounds=4, site_weights=jnp.asarray(weights), sequences_are_masks=True,
    )
    np.testing.assert_array_equal(support, ref_support)
    for ours, ref in zip(best, ref_best):
        np.testing.assert_array_equal(ours.children.numpy(), np.asarray(ref.children))
    assert support[-1] == 1.0
    np.testing.assert_array_equal(
        bootstrap.split_support(topo, best[:3]), jax_bootstrap.split_support(jax_topo, ref_best[:3]))


def test_bootstrap_weights_and_scores(data):
    topo, jax_topo, masks, weights = data
    generator = torch.Generator().manual_seed(1)
    plain = bootstrap.bootstrap_site_weights(LENGTH, 5, generator)
    assert plain.shape == (5, LENGTH) and (plain.sum(1) == LENGTH).all()
    resampled = bootstrap._replicate_weights(LENGTH, 5, weights, generator)
    assert (resampled.sum(1) == int(weights.sum())).all()
    states = np.random.default_rng(2).integers(0, 4, (N_LEAVES, LENGTH))
    for use_fitch in (True, False):
        ours = bootstrap.bootstrap_scores(topo, CostModel.hamming(4).matrix,
                                          torch.as_tensor(states), plain, use_fitch)
        ref = jax_bootstrap.bootstrap_scores(jax_topo, JaxCostModel.hamming(4).matrix,
                                             jnp.asarray(states), jnp.asarray(plain.numpy()),
                                             use_fitch)
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


def test_spr_decay_support_matches_jax(data):
    _, _, masks, weights = data
    # Decay on the climbed tree, where most splits cost steps to break.
    climbed = jax_climb(data[1], JaxCostModel.hamming(4).matrix, jnp.asarray(masks),
                        neighborhood="spr-scan", site_weights=jnp.asarray(weights),
                        sequences_are_masks=True)
    children = np.array(climbed.topology.children)
    ours = spr_decay_support(from_numpy(children, parents_of(children)), torch.as_tensor(masks),
                             torch.as_tensor(weights), sequences_are_masks=True)
    ref = jax_decay(climbed.topology, jnp.asarray(masks), jnp.asarray(weights),
                    sequences_are_masks=True)
    np.testing.assert_array_equal(np.isnan(ours[0]), np.isnan(ref[0]))
    np.testing.assert_array_equal(ours[0], ref[0])
    assert ours[1] == float(ref[1]) and (~np.isnan(ours[0])).sum() > N_LEAVES // 2


def test_spr_decay_support_runs_where_it_is_asked(data):
    topo, _, masks, weights = data
    if not torch.cuda.is_available():
        # Host arrays and no device named: the card, which is missing.
        with pytest.raises(RuntimeError, match="no CUDA device"):
            spr_decay_support(topo, masks, weights, sequences_are_masks=True)
    on_cpu = spr_decay_support(topo, masks, weights, sequences_are_masks=True, device="cpu")
    from_tensors = spr_decay_support(topo, torch.as_tensor(masks), torch.as_tensor(weights),
                                     sequences_are_masks=True)
    np.testing.assert_array_equal(on_cpu[0], from_tensors[0])
    assert on_cpu[1] == from_tensors[1]


@pytest.mark.parametrize("max_cells", [None, 7])
def test_segmented_scans_match_jax(data, max_cells):
    topo, jax_topo, masks, weights = data
    kwargs = {} if max_cells is None else {"max_cells": max_cells}
    ours, base = spr_scan_segmented(topo, torch.as_tensor(masks), torch.as_tensor(weights),
                                    sequences_are_masks=True, **kwargs)
    ref, ref_base = jax_scan_segmented(jax_topo, jnp.asarray(masks), jnp.asarray(weights),
                                       sequences_are_masks=True, **kwargs)
    assert ours.shape == (2 * N_LEAVES - 1,) * 2
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    assert float(base) == float(ref_base)
    best = spr_scan_best(topo, torch.as_tensor(masks), torch.as_tensor(weights),
                         sequences_are_masks=True)
    ref_best = jax_scan_best(jax_topo, jnp.asarray(masks), jnp.asarray(weights),
                             sequences_are_masks=True)
    assert best == tuple(float(x) if i in (0, 3) else int(x) for i, x in enumerate(ref_best))


def test_tree_distances_match_jax():
    rng = np.random.default_rng(12)
    trees = random_children(rng, N_LEAVES, 4)
    ours = [from_numpy(c, parents_of(c)) for c in trees]
    refs = [JaxTopology(children=c, parents=parents_of(c)) for c in trees]
    for a, ra in zip(ours, refs):
        assert ratchet.unrooted_splits(a) == jax_ratchet.unrooted_splits(ra)
        for b, rb in zip(ours, refs):
            assert ratchet.robinson_foulds(a, b) == jax_ratchet.robinson_foulds(ra, rb)
            assert ratchet.rf_distance_unrooted(a, b) == jax_ratchet.rf_distance_unrooted(ra, rb)
