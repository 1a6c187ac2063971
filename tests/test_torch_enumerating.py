"""The enumerating climbs (``neighborhood="spr"`` and ``"tbr"``, random
kicks, constraint splits), ``constraint_mask``, ``constrained_start`` and
the batched stepwise path of ``trex_tpu_torch`` against ``trex_tpu`` on the
same inputs: the same trees, scores, rounds and evaluations."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from _torch_parity import (
    integer_weights,
    jitted_jax_scores,
    parents_of,
    random_children,
    random_masks,
)

import trex_tpu.io as jax_io
import trex_tpu_torch.io as tio
from trex_tpu.search.hillclimb import constrained_start as jax_constrained_start
from trex_tpu.search.hillclimb import constraint_mask as jax_constraint_mask
from trex_tpu.search.hillclimb import parsimony_hill_climb as jax_climb
from trex_tpu.search.stepwise import stepwise_addition as jax_stepwise
from trex_tpu.topology import Topology as JaxTopology
from trex_tpu.types import CostModel as JaxCostModel
from trex_tpu_torch.search.bootstrap import subtree_leaf_sets
from trex_tpu_torch.search.hillclimb import (
    constrained_start,
    constraint_mask,
    parsimony_hill_climb,
)
from trex_tpu_torch.search.stepwise import stepwise_addition
from trex_tpu_torch.topology import from_numpy
from trex_tpu_torch.types import CostModel

N_LEAVES, LENGTH = 12, 48


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(31)
    children = random_children(rng, N_LEAVES, 1)[0]
    return children, parents_of(children), random_masks(rng, N_LEAVES, LENGTH), \
        integer_weights(rng, LENGTH)


@pytest.fixture
def same_generators(monkeypatch):
    """The port's generators in the JAX package's mode: both native, or
    both Python where the JAX package's library is not loaded (a truncated
    TBR sample and the sampler draw from other streams in the two modes)."""
    monkeypatch.setattr(tio.native, "available", lambda: jax_io.native.available())


@pytest.fixture(autouse=True)
def _jitted(monkeypatch):
    jitted_jax_scores(monkeypatch)


def _jax_scorer(weights):
    """The JAX CLI's enumerating scorer: the dispatch with weights and masks."""
    from trex_tpu.ops import dispatch

    return lambda topos, cost, leaves: dispatch.batched_scores_fastest(
        topos, cost, leaves, jnp.asarray(weights), sequences_are_masks=True)


def _climbs(data, start_children=None, **kwargs):
    children, parents, masks, weights = data
    if start_children is not None:
        children, parents = start_children, parents_of(start_children)
    seed = kwargs.pop("seed", None)
    ours = parsimony_hill_climb(
        from_numpy(children, parents), CostModel.hamming(4).matrix, masks,
        site_weights=weights, sequences_are_masks=True, device="cpu", seed=seed, **kwargs,
    )
    ref = jax_climb(
        JaxTopology(children=jnp.asarray(children), parents=jnp.asarray(parents)),
        JaxCostModel.hamming(4).matrix, jnp.asarray(masks),
        score_batch_fn=_jax_scorer(weights),
        key=None if seed is None else jax.random.PRNGKey(seed), **kwargs,
    )
    return ours, ref


def _assert_same(ours, ref):
    np.testing.assert_array_equal(ours.topology.children.numpy(), np.asarray(ref.topology.children))
    assert (ours.score, ours.rounds, ours.evaluations) == (ref.score, ref.rounds, ref.evaluations)
    assert ours.trace == ref.trace


@pytest.mark.parametrize(
    "kwargs",
    [
        dict(neighborhood="spr", max_rounds=6),
        dict(neighborhood="tbr", tbr_budget=150, max_rounds=4),
        dict(neighborhood="nni", random_kicks=5, seed=7, max_rounds=5),
        dict(neighborhood="tbr", tbr_budget=80, random_kicks=3, seed=2, max_rounds=3),
    ],
    ids=["spr", "tbr", "nni-kicks", "tbr-kicks"],
)
def test_enumerating_climbs_match_jax(data, same_generators, kwargs):
    ours, ref = _climbs(data, **kwargs)
    assert ours.rounds > 0
    _assert_same(ours, ref)


def _constraint(data):
    """Two clades of the data's tree (on 6 of its taxa) as a constraint."""
    children = data[0]
    clades = [c for c in subtree_leaf_sets(from_numpy(children, parents_of(children)))
              if 2 <= len(c) <= 4]
    return [clades[0], clades[-1]]


def test_constraint_mask_matches_jax(data):
    rng = np.random.default_rng(2)
    batch = random_children(rng, N_LEAVES, 200)
    batch = np.concatenate([batch, data[0][None]])
    splits = _constraint(data)
    for taxa in (None, frozenset().union(*splits)):
        ours = constraint_mask(splits, N_LEAVES, taxa)(batch)
        ref = jax_constraint_mask(splits, N_LEAVES, taxa)(batch)
        np.testing.assert_array_equal(ours, ref)
        assert ours[-1]
    assert constraint_mask([], N_LEAVES)(batch).all()
    with pytest.raises(ValueError):
        constraint_mask([frozenset({0, 1})], N_LEAVES, frozenset({2, 3}))


def _constraint_tree(seed):
    rng = np.random.default_rng(seed)
    ids = rng.permutation(N_LEAVES)[:6].tolist()
    children = random_children(rng, 6, 1)[0]
    return children, parents_of(children), ids


@pytest.mark.parametrize("seed", [0, 1])
def test_constrained_start_matches_jax(seed):
    children, parents, ids = _constraint_tree(seed)
    ours = constrained_start(from_numpy(children, parents), ids, N_LEAVES, seed=seed,
                             device="cpu")
    ref = jax_constrained_start(JaxTopology(children=children, parents=parents), ids,
                                N_LEAVES, seed=seed)
    np.testing.assert_array_equal(ours.children.numpy(), np.asarray(ref.children))
    np.testing.assert_array_equal(ours.parents.numpy(), np.asarray(ref.parents))


@pytest.mark.parametrize("neighborhood", ["nni", "spr"])
def test_constrained_climb_matches_jax(data, neighborhood):
    children, parents, ids = _constraint_tree(3)
    clades = [frozenset(ids[i] for i in c)
              for c in subtree_leaf_sets(from_numpy(children, parents))]
    splits = [c for c in clades if 2 <= len(c) <= 4]
    start = constrained_start(from_numpy(children, parents), ids, N_LEAVES, seed=3,
                              device="cpu")
    ours, ref = _climbs(data, start.children.numpy(), neighborhood=neighborhood,
                        max_rounds=5, constraint_splits=splits,
                        constraint_taxa=frozenset(ids))
    _assert_same(ours, ref)
    assert constraint_mask(splits, N_LEAVES, frozenset(ids))(
        ours.topology.children.numpy()[None])[0]
    with pytest.raises(ValueError, match="spr-scan"):
        parsimony_hill_climb(start, CostModel.hamming(4).matrix, data[2], device="cpu",
                             neighborhood="spr-scan", constraint_splits=splits)


def _same_tree(ours, ref):
    np.testing.assert_array_equal(ours[0].children.numpy(), np.asarray(ref[0].children))
    np.testing.assert_array_equal(ours[0].parents.numpy(), np.asarray(ref[0].parents))
    assert ours[1] == ref[1]


def test_batched_stepwise_matches_jax(data):
    _, _, masks, weights = data
    ours = stepwise_addition(masks, 4, sequences_are_masks=True, seed=1,
                             site_weights=weights, use_scan=False, device="cpu")
    ref = jax_stepwise(masks, 4, sequences_are_masks=True, seed=1,
                       site_weights=jnp.asarray(weights), use_scan=False)
    _same_tree(ours, ref)


def test_batched_stepwise_at_32_states():
    rng = np.random.default_rng(32)
    states = rng.integers(0, 31, (N_LEAVES, LENGTH))
    masks = (1 << states).astype(np.int32)
    # At 32 states the JAX package's batched path overflows building its
    # full mask (np.int32(2**32 - 1)); on masks within 31 bits a fully
    # ambiguous leaf scores alike with 31 or 32 bits set, so its Q = 31 run
    # is the reference.
    ours = stepwise_addition(masks, 32, sequences_are_masks=True, seed=4, device="cpu")
    ref = jax_stepwise(masks, 31, sequences_are_masks=True, seed=4, use_scan=False)
    _same_tree(ours, ref)
    # Bit 31 read like any other: swapping state 31 for state 30 changes
    # nothing (Fitch is blind to the states' names).
    swapped = np.where(states == 30, 31, states)
    ours31 = stepwise_addition(((1 << swapped).astype(np.int64) - ((swapped == 31) << 32))
                               .astype(np.int32), 32, sequences_are_masks=True, seed=4,
                               device="cpu")
    _same_tree(ours31, ref)
    with pytest.raises(ValueError, match="at most 32"):
        stepwise_addition(masks, 33, sequences_are_masks=True, device="cpu")
    with pytest.raises(ValueError, match="scan path"):
        stepwise_addition(masks, 32, sequences_are_masks=True, use_scan=True, device="cpu")
