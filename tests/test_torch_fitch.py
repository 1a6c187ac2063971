"""Parity of the port's Fitch scoring (K1's plain version) with trex_tpu.

Exact equality throughout: parsimony scores are integer-valued f32 sums
with integer site weights.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import integer_weights, parents_of, random_children, random_masks

from trex_tpu.ops.fitch import fitch_reconstruct as jax_fitch_reconstruct
from trex_tpu.ops.fitch import fitch_score as jax_fitch_score
from trex_tpu.ops.fitch import fitch_state_sets as jax_fitch_state_sets
from trex_tpu.ops.sankoff_pallas import batched_fitch_score_pallas
from trex_tpu.topology import Topology as JaxTopology
from trex_tpu_torch.ops.dispatch import batched_scores_fastest
from trex_tpu_torch.ops.fitch import (
    batched_fitch_score,
    fitch_reconstruct,
    fitch_score,
    fitch_state_sets,
)
from trex_tpu_torch.ops.fitch_cuda import (
    batched_fitch_score_cuda,
    batched_fitch_score_plain,
)
from trex_tpu_torch.topology import from_numpy
from trex_tpu_torch.types import CostModel

N_LEAVES, LENGTH, BATCH = 8, 200, 4


def _inputs(seed):
    rng = np.random.default_rng(seed)
    children = random_children(rng, N_LEAVES, BATCH)
    return children, random_masks(rng, N_LEAVES, LENGTH), integer_weights(rng, LENGTH)


def _jax_topo(children):
    return JaxTopology(
        children=jnp.asarray(children), parents=jnp.asarray(parents_of(children))
    )


@pytest.mark.parametrize("seed", [0, 1])
def test_fitch_score_matches_jax(seed):
    children, masks, weights = _inputs(seed)
    for b in range(BATCH):
        ours = fitch_score(
            from_numpy(children[b], parents_of(children[b])),
            torch.as_tensor(masks), torch.as_tensor(weights),
            sequences_are_masks=True,
        )
        ref = jax_fitch_score(
            _jax_topo(children[b]), jnp.asarray(masks), jnp.asarray(weights),
            sequences_are_masks=True,
        )
        assert ours.dtype == torch.float32
        assert float(ours) == float(ref)


def test_fitch_score_integer_states_unweighted():
    rng = np.random.default_rng(7)
    children = random_children(rng, N_LEAVES, 1)[0]
    states = rng.integers(0, 4, (N_LEAVES, LENGTH)).astype(np.int32)
    ours = fitch_score(from_numpy(children, parents_of(children)), torch.as_tensor(states))
    ref = jax_fitch_score(_jax_topo(children), jnp.asarray(states))
    assert float(ours) == float(ref)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_batched_plain_matches_pallas_interpret(seed):
    children, masks, weights = _inputs(seed)
    plain = batched_fitch_score_plain(
        torch.as_tensor(children), torch.as_tensor(masks), torch.as_tensor(weights)
    )
    ref = batched_fitch_score_pallas(
        _jax_topo(children), jnp.asarray(masks), site_weights=jnp.asarray(weights),
        sequences_are_masks=True, n_states=4, interpret=True,
    )
    np.testing.assert_array_equal(plain.numpy(), np.asarray(ref))


def test_cpu_wrapper_runs_plain_and_counts_no_launch():
    children, masks, weights = _inputs(3)
    args = (torch.as_tensor(children), torch.as_tensor(masks), torch.as_tensor(weights))
    before = batched_fitch_score_cuda.launches
    np.testing.assert_array_equal(
        batched_fitch_score_cuda(*args).numpy(),
        batched_fitch_score_plain(*args).numpy(),
    )
    assert batched_fitch_score_cuda.launches == before


def test_batched_entry_and_dispatch_agree():
    children, masks, weights = _inputs(4)
    topos = from_numpy(children, parents_of(children))
    direct = batched_fitch_score(
        topos, torch.as_tensor(masks), torch.as_tensor(weights),
        sequences_are_masks=True,
    )
    dispatched = batched_scores_fastest(
        topos, CostModel.hamming(4).matrix, torch.as_tensor(masks),
        torch.as_tensor(weights), sequences_are_masks=True,
    )
    np.testing.assert_array_equal(direct.numpy(), dispatched.numpy())


@pytest.mark.parametrize("masks", [True, False])
def test_state_sets_and_reconstruction_match_jax(masks):
    children, leaves, _ = _inputs(7)
    if not masks:
        leaves = np.random.default_rng(7).integers(0, 4, leaves.shape).astype(np.int32)
    topo = from_numpy(children[0], parents_of(children[0]))
    sets, ambiguity = fitch_state_sets(topo, torch.as_tensor(leaves), sequences_are_masks=masks)
    ref_sets, ref_ambiguity = jax_fitch_state_sets(
        _jax_topo(children[0]), jnp.asarray(leaves), sequences_are_masks=masks
    )
    np.testing.assert_array_equal(sets.numpy(), np.asarray(ref_sets))
    np.testing.assert_array_equal(ambiguity.numpy(), np.asarray(ref_ambiguity))
    seqs, score = fitch_reconstruct(topo, torch.as_tensor(leaves), 4, sequences_are_masks=masks)
    ref_seqs, ref_score = jax_fitch_reconstruct(
        _jax_topo(children[0]), jnp.asarray(leaves), n_states=4, sequences_are_masks=masks
    )
    np.testing.assert_array_equal(seqs.numpy(), np.asarray(ref_seqs))
    assert score.dtype == torch.float32 and float(score) == float(ref_score)


def test_dispatch_rejects_general_costs():
    # General costs go to the Sankoff kernel (K5), which takes state-set
    # masks only up to 32 states: a larger general cost on masks is refused.
    children, masks, _ = _inputs(5)
    cost = CostModel.hamming(40).matrix * 2.0
    with pytest.raises(ValueError, match="at most 32 states"):
        batched_scores_fastest(
            from_numpy(children, parents_of(children)), cost, torch.as_tensor(masks),
            sequences_are_masks=True,
        )


def test_wrapper_validates_inputs():
    children, masks, weights = _inputs(6)
    ch, m, w = (torch.as_tensor(x) for x in (children, masks, weights))
    with pytest.raises(TypeError):
        batched_fitch_score_cuda(ch.long(), m, w)
    with pytest.raises(TypeError):
        batched_fitch_score_cuda(ch, m, w.double())
    with pytest.raises(ValueError):
        batched_fitch_score_cuda(ch, m[:-1], w)
    with pytest.raises(ValueError):
        batched_fitch_score_cuda(ch, m, w[:-1])
