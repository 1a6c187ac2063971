"""Parity of the port's plain-torch Sankoff DP (``trex_tpu_torch.ops.sankoff``)
and topology helpers with trex_tpu's.

Bit-equal throughout: every DP value is a min of sums of integer costs
(exact in float32), argmins take the first minimal child state in both
packages, and scores are integer-valued sums. The general cost is
asymmetric, so a transposed ``[parent, child]`` layout would fail.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import integer_weights, parents_of, random_children, random_masks

from trex_tpu import topology as jax_topology
from trex_tpu.ops import sankoff as jax_sankoff
from trex_tpu.topology import Topology as JaxTopology
from trex_tpu.types import CostModel as JaxCostModel
from trex_tpu_torch import topology
from trex_tpu_torch.ops import sankoff
from trex_tpu_torch.topology import from_numpy
from trex_tpu_torch.types import CostModel

N_LEAVES, LENGTH = 8, 96


def _asymmetric_cost(rng, q):
    cost = rng.integers(0, 4, (q, q)).astype(np.float32)
    np.fill_diagonal(cost, 0.0)
    assert not np.array_equal(cost, cost.T)
    return cost


def _case(name, seed):
    """(cost (Q, Q), integer leaf states) for one named cost."""
    rng = np.random.default_rng(seed)
    if name == "transition_transversion":
        cost = np.array(JaxCostModel.transition_transversion(1.0, 2.0).matrix)
        q = 4
    elif name == "asymmetric":
        q = 5
        cost = _asymmetric_cost(rng, q)
    else:  # Hamming at Q = 40, past the Fitch limit of 32 states
        q = 40
        cost = np.ones((q, q), np.float32) - np.eye(q, dtype=np.float32)
    return cost, rng.integers(0, q, (N_LEAVES, LENGTH)).astype(np.int32), rng


def _trees(rng, batch=1):
    children = random_children(rng, N_LEAVES, batch)
    return children, parents_of(children)


def _jax_topo(children, parents):
    return JaxTopology(jnp.asarray(children), jnp.asarray(parents))


CASES = ["transition_transversion", "asymmetric", "hamming40"]


def test_transition_transversion_matrix_matches_jax():
    for args in ((), (1.0, 2.5)):
        np.testing.assert_array_equal(
            CostModel.transition_transversion(*args).matrix.numpy(),
            np.asarray(JaxCostModel.transition_transversion(*args).matrix),
        )


@pytest.mark.parametrize("masks", [False, True])
def test_leaf_tables_match_jax(masks):
    rng = np.random.default_rng(1)
    if masks:
        leaves = random_masks(rng, N_LEAVES, LENGTH)
        ours = sankoff.leaf_dp_table_from_masks(torch.as_tensor(leaves), 4)
        ref = jax_sankoff.leaf_dp_table_from_masks(jnp.asarray(leaves), 4)
    else:
        leaves = rng.integers(-1, 4, (N_LEAVES, LENGTH)).astype(np.int32)
        ours = sankoff.leaf_dp_table(torch.as_tensor(leaves), 4)
        ref = jax_sankoff.leaf_dp_table(jnp.asarray(leaves), 4)
    assert ours.dtype == torch.float32
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


@pytest.mark.parametrize("name", CASES)
def test_tables_and_reconstruction_match_jax(name):
    cost, leaves, rng = _case(name, 2)
    children, parents = _trees(rng)
    ours_t = from_numpy(children[0], parents[0])
    ref_t = _jax_topo(children[0], parents[0])
    dp, back = sankoff.sankoff_tables(ours_t, torch.as_tensor(cost), torch.as_tensor(leaves))
    ref_dp, ref_back = jax_sankoff.sankoff_tables(ref_t, jnp.asarray(cost), jnp.asarray(leaves))
    np.testing.assert_array_equal(dp.numpy(), np.asarray(ref_dp))
    np.testing.assert_array_equal(back.numpy(), np.asarray(ref_back))
    seqs, dp2, score = sankoff.sankoff_reconstruct(
        ours_t, torch.as_tensor(cost), torch.as_tensor(leaves)
    )
    ref_seqs, _, ref_score = jax_sankoff.sankoff_reconstruct(
        ref_t, jnp.asarray(cost), jnp.asarray(leaves)
    )
    np.testing.assert_array_equal(seqs.numpy(), np.asarray(ref_seqs))
    np.testing.assert_array_equal(dp2.numpy(), dp.numpy())
    assert float(score) == float(ref_score)


@pytest.mark.parametrize("name", CASES)
def test_scores_match_jax(name):
    cost, leaves, rng = _case(name, 3)
    children, parents = _trees(rng, batch=3)
    mask = integer_weights(rng, LENGTH)
    hamming = name == "hamming40"
    ours = sankoff.batched_sankoff_score(
        from_numpy(children, parents), torch.as_tensor(cost), torch.as_tensor(leaves),
        torch.as_tensor(mask), hamming=hamming,
    )
    for b in range(3):
        single = sankoff.sankoff_score(
            from_numpy(children[b], parents[b]), torch.as_tensor(cost),
            torch.as_tensor(leaves), torch.as_tensor(mask), hamming=hamming,
        )
        ref = jax_sankoff.sankoff_score(
            _jax_topo(children[b], parents[b]), jnp.asarray(cost), jnp.asarray(leaves),
            site_mask=jnp.asarray(mask), hamming=hamming,
        )
        assert float(ours[b]) == float(single) == float(ref)
    if hamming:
        closed = sankoff.batched_sankoff_score_hamming(
            from_numpy(children, parents), torch.as_tensor(cost), torch.as_tensor(leaves),
            torch.as_tensor(mask),
        )
        general = sankoff.batched_sankoff_score(
            from_numpy(children, parents), torch.as_tensor(cost), torch.as_tensor(leaves),
            torch.as_tensor(mask),
        )
        np.testing.assert_array_equal(closed.numpy(), general.numpy())


def test_masked_leaves_match_jax():
    rng = np.random.default_rng(4)
    cost = _asymmetric_cost(rng, 4)
    masks = random_masks(rng, N_LEAVES, LENGTH, ambiguity=0.3)
    children, parents = _trees(rng)
    ours_t = from_numpy(children[0], parents[0])
    ref_t = _jax_topo(children[0], parents[0])
    score = sankoff.sankoff_score(
        ours_t, torch.as_tensor(cost), torch.as_tensor(masks), sequences_are_masks=True
    )
    ref = jax_sankoff.sankoff_score(
        ref_t, jnp.asarray(cost), jnp.asarray(masks), sequences_are_masks=True
    )
    assert float(score) == float(ref)
    seqs, _, _ = sankoff.sankoff_reconstruct(
        ours_t, torch.as_tensor(cost), torch.as_tensor(masks), sequences_are_masks=True
    )
    ref_seqs, _, _ = jax_sankoff.sankoff_reconstruct(
        ref_t, jnp.asarray(cost), jnp.asarray(masks), sequences_are_masks=True
    )
    np.testing.assert_array_equal(seqs.numpy(), np.asarray(ref_seqs))


def test_tied_argmin_takes_the_first_state():
    # A zero cost matrix makes every state tie at every node: the root and
    # every backtracked ancestor must take the first state, 0, although
    # every leaf is in state 3.
    cost = np.zeros((4, 4), np.float32)
    leaves = np.full((N_LEAVES, 5), 3, np.int32)
    children, parents = _trees(np.random.default_rng(5))
    seqs, _, score = sankoff.sankoff_reconstruct(
        from_numpy(children[0], parents[0]), torch.as_tensor(cost), torch.as_tensor(leaves)
    )
    ref_seqs, _, ref_score = jax_sankoff.sankoff_reconstruct(
        _jax_topo(children[0], parents[0]), jnp.asarray(cost), jnp.asarray(leaves)
    )
    np.testing.assert_array_equal(seqs.numpy(), np.asarray(ref_seqs))
    assert (seqs[N_LEAVES:] == 0).all() and float(score) == float(ref_score) == 0.0


@pytest.mark.parametrize("return_path", [False, True])
def test_run_sankoff_matches_jax(return_path):
    cost, leaves, rng = _case("asymmetric", 6)
    adjacency = np.array(jax_topology.balanced_adjacency(N_LEAVES))
    adjacency[-1, -1] = 1.0  # a root self-loop is tolerated
    n_all = 2 * N_LEAVES - 1
    seqs = np.zeros((n_all, LENGTH), np.int32)
    seqs[:N_LEAVES] = leaves
    ours = sankoff.run_sankoff(
        torch.as_tensor(adjacency), torch.as_tensor(cost), torch.as_tensor(seqs),
        n_all, 5, N_LEAVES, return_path=return_path,
    )
    ref = jax_sankoff.run_sankoff(
        jnp.asarray(adjacency), jnp.asarray(cost), jnp.asarray(seqs),
        n_all, 5, N_LEAVES, return_path=return_path,
    )
    for got, want in zip(ours, ref):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("seed", [0, 7, 123])
def test_random_topologies_match_jax(seed):
    ours = topology.random_topologies(seed, 11, 5)
    ref = jax_topology.random_topologies(jax.random.PRNGKey(seed), 11, 5)
    np.testing.assert_array_equal(ours.children.numpy(), np.asarray(ref.children))
    np.testing.assert_array_equal(ours.parents.numpy(), np.asarray(ref.parents))


def test_topology_converters_match_jax():
    balanced = topology.balanced_topology(N_LEAVES)
    ref = jax_topology.balanced_topology(N_LEAVES)
    np.testing.assert_array_equal(balanced.children.numpy(), np.asarray(ref.children))
    np.testing.assert_array_equal(balanced.parents.numpy(), np.asarray(ref.parents))
    np.testing.assert_array_equal(
        topology.balanced_adjacency(N_LEAVES).numpy(),
        np.asarray(jax_topology.balanced_adjacency(N_LEAVES)),
    )
    children, parents = _trees(np.random.default_rng(8))
    ours_t = from_numpy(children[0], parents[0])
    adjacency = topology.topology_to_adjacency(ours_t)
    np.testing.assert_array_equal(
        adjacency.numpy(),
        np.asarray(jax_topology.topology_to_adjacency(_jax_topo(children[0], parents[0]))),
    )
    back = topology.topology_from_adjacency(adjacency, N_LEAVES)
    ref_back = jax_topology.topology_from_adjacency(jnp.asarray(adjacency.numpy()), N_LEAVES)
    np.testing.assert_array_equal(back.children.numpy(), np.asarray(ref_back.children))
    np.testing.assert_array_equal(back.parents.numpy(), np.asarray(ref_back.parents))
    from_parents = topology.parents_to_topology(torch.as_tensor(parents[0]), N_LEAVES)
    ref_parents = jax_topology.parents_to_topology(jnp.asarray(parents[0]), N_LEAVES)
    np.testing.assert_array_equal(from_parents.children.numpy(), np.asarray(ref_parents.children))
    np.testing.assert_array_equal(from_parents.children.numpy(), children[0])
