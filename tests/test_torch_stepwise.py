"""Parity of the port's stepwise addition with trex_tpu's scan path."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import integer_weights, random_masks

from trex_tpu.search.stepwise import stepwise_addition as jax_stepwise
from trex_tpu.search.stepwise import stepwise_addition_multi as jax_stepwise_multi
from trex_tpu_torch.search.stepwise import stepwise_addition, stepwise_addition_multi

N_LEAVES = 12
LENGTH = 45  # not a multiple of the 16-site padding


def _assert_same(ours, ref):
    topo, score = ours
    ref_topo, ref_score = ref
    np.testing.assert_array_equal(topo.children.numpy(), np.asarray(ref_topo.children))
    np.testing.assert_array_equal(topo.parents.numpy(), np.asarray(ref_topo.parents))
    assert score == ref_score


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_masks_and_weights_match_jax(seed):
    rng = np.random.default_rng(seed)
    masks = random_masks(rng, N_LEAVES, LENGTH, ambiguity=0.2)
    weights = integer_weights(rng, LENGTH)
    ours = stepwise_addition(
        masks, 4, sequences_are_masks=True, seed=seed, site_weights=weights,
        device="cpu",
    )
    ref = jax_stepwise(
        masks, 4, sequences_are_masks=True, seed=seed,
        site_weights=jnp.asarray(weights),
    )
    _assert_same(ours, ref)


def test_integer_states_explicit_order_match_jax():
    rng = np.random.default_rng(3)
    states = rng.integers(0, 4, (N_LEAVES, LENGTH))
    order = rng.permutation(N_LEAVES)
    ours = stepwise_addition(states, 4, order=order, device="cpu")
    _assert_same(ours, jax_stepwise(states, 4, order=order))


def test_multi_order_matches_jax():
    rng = np.random.default_rng(4)
    masks = random_masks(rng, N_LEAVES, LENGTH)
    weights = integer_weights(rng, LENGTH)
    ours = stepwise_addition_multi(
        masks, 4, n_orders=4, seed=9, sequences_are_masks=True,
        site_weights=torch.as_tensor(weights), device="cpu",
    )
    ref = jax_stepwise_multi(
        masks, 4, n_orders=4, seed=9, sequences_are_masks=True,
        site_weights=jnp.asarray(weights),
    )
    _assert_same(ours, ref)


def test_validation():
    rng = np.random.default_rng(5)
    states = rng.integers(0, 4, (N_LEAVES, LENGTH))
    with pytest.raises(ValueError, match="at least 3"):
        stepwise_addition(states[:2], 4, device="cpu")
    with pytest.raises(ValueError, match="permutation"):
        stepwise_addition(states, 4, order=np.zeros(N_LEAVES, int), device="cpu")
    with pytest.raises(NotImplementedError):
        stepwise_addition(states, 31, device="cpu")
