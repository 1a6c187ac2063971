"""Parity of the port's stepwise addition with trex_tpu's scan path."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import integer_weights, random_masks

from trex_tpu.search.stepwise import stepwise_addition as jax_stepwise
from trex_tpu.search.stepwise import stepwise_addition_multi as jax_stepwise_multi
from trex_tpu_torch.search.stepwise import (
    mask_alphabet,
    stepwise_addition,
    stepwise_addition_multi,
)

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


def test_mask_alphabet():
    # K1's alphabet on the card: n_states, or one past the highest bit the
    # masks use (bit 31, the int32 sign bit, gives 32).
    masks = np.array([[1, 2, 4], [8, 3, 15]], np.int32)
    assert mask_alphabet(masks, 4) == 4
    assert mask_alphabet(masks, 20) == 20
    assert mask_alphabet(masks | (1 << 5), 4) == 6
    assert mask_alphabet(masks | (1 << 29), 4) == 30
    assert mask_alphabet(masks | (1 << 30), 4) == 31
    assert mask_alphabet(np.array([[1, -(1 << 31)]], np.int32), 4) == 32


def test_rescoring_hands_k1_every_mask_bit(monkeypatch):
    # The exact rescoring passes K1 the alphabet the masks use, so on the
    # card it reads the bits the CPU reads.
    from trex_tpu_torch.search import stepwise

    seen = []
    rescore = stepwise.fitch_score

    def recorded(*args, n_states=None, **kwargs):
        seen.append(n_states)
        return rescore(*args, n_states=n_states, **kwargs)

    monkeypatch.setattr(stepwise, "fitch_score", recorded)
    masks = random_masks(np.random.default_rng(6), N_LEAVES, LENGTH)
    stepwise_addition(masks, 4, sequences_are_masks=True, device="cpu")
    masks[3, 7] |= 1 << 9
    stepwise_addition(masks, 4, sequences_are_masks=True, device="cpu")
    assert seen == [4, 10]


@pytest.mark.parametrize("bit", [5, 30, 31])
def test_masks_above_the_alphabet_match_jax(bit):
    # A fifth of the masks carry a bit at or above n_states = 4: the JAX
    # package reads every bit (its up sets drop bits 30 and 31, its exact
    # rescoring keeps them), and so does the port.
    rng = np.random.default_rng(bit)
    masks = random_masks(rng, N_LEAVES, LENGTH).astype(np.int64)
    masks[rng.random(masks.shape) < 0.2] |= 1 << bit
    masks = (masks - ((masks >> 31) << 32)).astype(np.int32)
    ours = stepwise_addition(masks, 4, sequences_are_masks=True, seed=1, device="cpu")
    _assert_same(ours, jax_stepwise(masks, 4, sequences_are_masks=True, seed=1))


def test_validation():
    rng = np.random.default_rng(5)
    states = rng.integers(0, 4, (N_LEAVES, LENGTH))
    with pytest.raises(ValueError, match="at least 3"):
        stepwise_addition(states[:2], 4, device="cpu")
    with pytest.raises(ValueError, match="permutation"):
        stepwise_addition(states, 4, order=np.zeros(N_LEAVES, int), device="cpu")
    with pytest.raises(ValueError, match="scan path"):
        stepwise_addition(states, 31, use_scan=True, device="cpu")
