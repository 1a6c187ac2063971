"""Parity of the port's all-SPR scan and hill climbs with trex_tpu."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import integer_weights, parents_of, random_children, random_masks

from trex_tpu.ops.spr_scan import spr_scan as jax_spr_scan
from trex_tpu.ops.spr_scan import spr_scan_best_segmented as jax_best_segmented
from trex_tpu.search.hillclimb import parsimony_hill_climb as jax_climb
from trex_tpu.topology import Topology as JaxTopology
from trex_tpu.types import CostModel as JaxCostModel
from trex_tpu_torch.ops import spr_scan as torch_scan
from trex_tpu_torch.search.hillclimb import parsimony_hill_climb
from trex_tpu_torch.topology import from_numpy
from trex_tpu_torch.types import CostModel

N_LEAVES, LENGTH = 9, 70


def _inputs(seed, n_leaves=N_LEAVES, length=LENGTH):
    rng = np.random.default_rng(seed)
    children = random_children(rng, n_leaves, 1)[0]
    return (
        children, parents_of(children), random_masks(rng, n_leaves, length),
        integer_weights(rng, length),
    )


def _both(children, parents):
    return (
        from_numpy(children, parents),
        JaxTopology(children=jnp.asarray(children), parents=jnp.asarray(parents)),
    )


@pytest.mark.parametrize("seed", [0, 1])
def test_full_scan_table_matches_jax(seed):
    children, parents, masks, weights = _inputs(seed)
    ours_t, ref_t = _both(children, parents)
    scores, base = torch_scan.spr_scan(
        ours_t, torch.as_tensor(masks), torch.as_tensor(weights),
        sequences_are_masks=True,
    )
    ref_scores, ref_base = jax_spr_scan(
        ref_t, jnp.asarray(masks), jnp.asarray(weights), sequences_are_masks=True,
    )
    ref_scores = np.asarray(ref_scores)
    assert scores.shape == ref_scores.shape == (2 * N_LEAVES - 1,) * 2
    np.testing.assert_array_equal(
        np.isinf(scores.numpy()), np.isinf(ref_scores)
    )
    np.testing.assert_array_equal(scores.numpy(), ref_scores)
    assert float(base) == float(ref_base)


def test_prune_subset_chunked_matches_jax():
    children, parents, masks, weights = _inputs(2)
    ours_t, ref_t = _both(children, parents)
    prune = np.array([0, 3, 11, 15, 4], np.int32)
    scores, _ = torch_scan.spr_scan(
        ours_t, torch.as_tensor(masks), torch.as_tensor(weights),
        sequences_are_masks=True, prune_nodes=torch.as_tensor(prune), prune_chunk=2,
    )
    ref, _ = jax_spr_scan(
        ref_t, jnp.asarray(masks), jnp.asarray(weights), sequences_are_masks=True,
        prune_nodes=jnp.asarray(prune),
    )
    np.testing.assert_array_equal(scores.numpy(), np.asarray(ref))


@pytest.mark.parametrize("max_cells", [17 * 3, 17 * 5, 1 << 20])
def test_best_segmented_matches_jax(max_cells):
    children, parents, masks, weights = _inputs(3)
    ours_t, ref_t = _both(children, parents)
    ours = torch_scan.spr_scan_best_segmented(
        ours_t, torch.as_tensor(masks), torch.as_tensor(weights),
        sequences_are_masks=True, max_cells=max_cells,
    )
    ref = jax_best_segmented(
        ref_t, jnp.asarray(masks), jnp.asarray(weights),
        sequences_are_masks=True, max_cells=max_cells,
    )
    assert ours == ref


def test_segment_best_masks_padding_rows_and_keeps_first_tie():
    scores = torch.tensor(
        [[5.0, 3.0, torch.inf], [3.0, 1.0, 1.0], [0.0, 0.0, 0.0]]
    )
    m, idx, cnt = torch_scan._segment_best(scores, 2)
    assert (float(m), int(idx), int(cnt)) == (1.0, 4, 5)


@pytest.mark.parametrize("neighborhood", ["spr-scan", "nni"])
def test_climb_from_random_start_matches_jax(neighborhood):
    rng = np.random.default_rng(5)
    n_leaves, length = 12, 60
    start = random_children(rng, n_leaves, 1)[0]
    states = rng.integers(0, 4, (n_leaves, length)).astype(np.int32)
    ours_t, ref_t = _both(start, parents_of(start))
    ours = parsimony_hill_climb(
        ours_t, CostModel.hamming(4).matrix, states,
        neighborhood=neighborhood, device="cpu",
    )
    ref = jax_climb(
        ref_t, JaxCostModel.hamming(4).matrix, jnp.asarray(states),
        neighborhood=neighborhood,
    )
    assert ours.rounds == ref.rounds > 0
    assert (ours.score, ours.evaluations) == (ref.score, ref.evaluations)
    assert ours.trace == ref.trace
    np.testing.assert_array_equal(
        ours.topology.children.numpy(), np.asarray(ref.topology.children)
    )
