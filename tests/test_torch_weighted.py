"""Weighted parsimony through the port's candidate dispatch: the general
cost matrices and Hamming past 32 states that K5 scores, and the NNI climb
under transition/transversion costs, against trex_tpu on the CPU.

Exact equality: integer costs give integer-valued float32 scores. The JAX
climb's default scorer ignores site weights and masks
(``trex_tpu/search/hillclimb.py``), so the climb is compared on integer
states without weights.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import integer_weights, parents_of, random_children, random_masks

from trex_tpu.ops.dispatch import batched_scores_fastest as jax_dispatch
from trex_tpu.search.hillclimb import parsimony_hill_climb as jax_climb
from trex_tpu.topology import Topology as JaxTopology
from trex_tpu.types import CostModel as JaxCostModel
from trex_tpu_torch.ops import dispatch
from trex_tpu_torch.search.hillclimb import parsimony_hill_climb
from trex_tpu_torch.search.stepwise import stepwise_addition
from trex_tpu_torch.topology import from_numpy
from trex_tpu_torch.types import CostModel


def _jax_topos(children):
    return JaxTopology(jnp.asarray(children), jnp.asarray(parents_of(children)))


def _costs(name):
    if name == "transition_transversion":
        return np.array(JaxCostModel.transition_transversion(1.0, 2.0).matrix), 4
    if name == "asymmetric":
        cost = np.random.default_rng(1).integers(0, 4, (6, 6)).astype(np.float32)
        np.fill_diagonal(cost, 0.0)
        return cost, 6
    return np.ones((40, 40), np.float32) - np.eye(40, dtype=np.float32), 40


@pytest.mark.parametrize("name", ["transition_transversion", "asymmetric", "hamming40"])
@pytest.mark.parametrize("weighted", [False, True])
def test_dispatch_matches_jax(name, weighted):
    rng = np.random.default_rng(2)
    cost, q = _costs(name)
    children = random_children(rng, 9, 5)
    leaves = rng.integers(0, q, (9, 120)).astype(np.int32)
    weights = integer_weights(rng, 120) if weighted else None
    ours = dispatch.batched_scores_fastest(
        from_numpy(children, parents_of(children)), torch.as_tensor(cost),
        torch.as_tensor(leaves), None if weights is None else torch.as_tensor(weights),
    )
    ref = jax_dispatch(
        _jax_topos(children), jnp.asarray(cost), jnp.asarray(leaves),
        None if weights is None else jnp.asarray(weights),
    )
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


def test_dispatch_scores_masks_under_a_general_cost():
    rng = np.random.default_rng(3)
    cost, _ = _costs("transition_transversion")
    children = random_children(rng, 9, 4)
    masks = random_masks(rng, 9, 100, ambiguity=0.3)
    ours = dispatch.batched_scores_fastest(
        from_numpy(children, parents_of(children)), torch.as_tensor(cost),
        torch.as_tensor(masks), sequences_are_masks=True,
    )
    ref = jax_dispatch(
        _jax_topos(children), jnp.asarray(cost), jnp.asarray(masks), sequences_are_masks=True
    )
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


def test_dispatch_gives_the_kernel_int32_leaves(monkeypatch):
    seen = []
    real = dispatch.batched_sankoff_score_cuda

    def spy(children, leaves, cost, weights, **kw):
        seen.append((children.dtype, leaves.dtype, cost.dtype, weights.dtype, kw["hamming"]))
        return real(children, leaves, cost, weights, **kw)

    monkeypatch.setattr(dispatch, "batched_sankoff_score_cuda", spy)
    rng = np.random.default_rng(4)
    children = random_children(rng, 6, 2)
    leaves = rng.integers(0, 4, (6, 50))  # numpy int64
    climb = parsimony_hill_climb(
        from_numpy(children[0], parents_of(children[0])),
        CostModel.transition_transversion().matrix, leaves, max_rounds=1, device="cpu",
    )
    assert climb.evaluations > 1 and seen
    assert set(seen) == {(torch.int32, torch.int32, torch.float32, torch.float32, False)}


def test_weighted_nni_climb_matches_jax():
    rng = np.random.default_rng(6)
    n_taxa, n_sites = 24, 300
    true_children = random_children(rng, n_taxa, 1)[0]
    seqs = np.empty((2 * n_taxa - 1, n_sites), np.int64)
    seqs[-1] = rng.integers(0, 4, n_sites)
    for a in range(n_taxa - 2, -1, -1):
        for c in true_children[a]:
            s = seqs[n_taxa + a].copy()
            hit = rng.random(n_sites) < 0.3
            s[hit] = rng.integers(0, 4, int(hit.sum()))
            seqs[c] = s
    leaves = seqs[:n_taxa].astype(np.int32)
    # The unit-cost stepwise tree, as on the card's weighted route: a few
    # weighted NNI rounds from it (the JAX climb's default scorer re-traces
    # its vmapped scan every round, so a long climb costs the suite minutes).
    start, _ = stepwise_addition(leaves, 4, seed=6, device="cpu")
    children, parents = start.to_numpy()
    ours = parsimony_hill_climb(
        start, CostModel.transition_transversion(1.0, 2.0).matrix,
        torch.as_tensor(leaves), neighborhood="nni", max_rounds=50,
    )
    ref = jax_climb(
        JaxTopology(jnp.asarray(children), jnp.asarray(parents)),
        JaxCostModel.transition_transversion(1.0, 2.0).matrix, jnp.asarray(leaves),
        neighborhood="nni", max_rounds=50,
    )
    assert ours.rounds >= 3
    np.testing.assert_array_equal(ours.topology.children.numpy(), np.asarray(ref.topology.children))
    assert (ours.score, ours.rounds, ours.evaluations) == (ref.score, ref.rounds, ref.evaluations)
    assert ours.trace == ref.trace
