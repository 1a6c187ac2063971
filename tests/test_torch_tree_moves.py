"""The samplers' device tree moves (``ops/tree_moves.py``) and the analytic
all-NNI rescoring (``ops/nni_scan.py``) against the JAX package on the same
numpy trees: moves integer-equal (the arbitrary device numbering too), the
rescored log-likelihoods within rtol 2e-5 (the cases of
``tests/test_nni_scan.py``). Trees of 4-13 taxa, 160 sites."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import random_children

import trex_tpu.ops.nni_scan as jax_scan
import trex_tpu.ops.tree_moves as jax_moves
from trex_tpu.ops.likelihood import gtr_eigensystem as jax_eigensystem
from trex_tpu.ops.likelihood import gtr_transition as jax_transition
from trex_tpu_torch.io import canonicalize_topology
from trex_tpu_torch.ops import nni_scan, tree_moves
from trex_tpu_torch.ops.likelihood import gtr_eigensystem
from trex_tpu_torch.search.mcmc import gtr_pmats

GTR_RATES = np.ones((4, 4), np.float32)
GTR_RATES[0, 2] = GTR_RATES[2, 0] = 3.0
GTR_FREQS = np.array([0.4, 0.1, 0.2, 0.3], np.float32)


def scrambled(rng, n_leaves: int, batch: int) -> np.ndarray:
    """Valid trees whose ancestors (all but the root) are numbered at random,
    so children may sit above their parents."""
    children = random_children(rng, n_leaves, batch)
    n_anc = n_leaves - 1
    out = np.empty_like(children)
    for b in range(batch):
        perm = np.concatenate([rng.permutation(n_anc - 1), [n_anc - 1]])
        new_of_old = np.concatenate([np.arange(n_leaves), n_leaves + perm])
        out[b, perm] = new_of_old[children[b]]
    return out


@pytest.mark.parametrize("n_leaves", [4, 5, 7, 9, 13])
def test_renumber_topological_equals_jax(n_leaves):
    rng = np.random.default_rng(n_leaves)
    trees = scrambled(rng, n_leaves, 6)
    got_c, got_o = tree_moves.renumber_topological(torch.as_tensor(trees), n_leaves)
    jax_fn = jax.jit(partial(jax_moves.renumber_topological, n_leaves=n_leaves))
    for b in range(trees.shape[0]):
        want_c, want_o = jax_fn(jnp.asarray(trees[b]))
        np.testing.assert_array_equal(got_c[b].numpy(), np.asarray(want_c))
        np.testing.assert_array_equal(got_o[b].numpy(), np.asarray(want_o))
        # The renumbered tree is the same tree, in index order.
        assert (got_c[b].numpy() < n_leaves + np.arange(n_leaves - 1)[:, None]).all()
        np.testing.assert_array_equal(canonicalize_topology(got_c[b].numpy())[0],
                                      canonicalize_topology(trees[b])[0])


@pytest.mark.parametrize("n_leaves", [4, 7, 13])
def test_nni_moves_equal_jax(n_leaves):
    rng = np.random.default_rng(100 + n_leaves)
    n_all = 2 * n_leaves - 1
    children = random_children(rng, n_leaves, 3)
    lengths = rng.exponential(0.1, (3, n_all)).astype(np.float32)
    got_c, got_l = tree_moves.nni_neighborhood_device(
        torch.as_tensor(children), torch.as_tensor(lengths), n_leaves)
    edge = rng.integers(0, n_leaves - 2, 3)
    variant = rng.integers(0, 2, 3)
    one_c, one_l = tree_moves.nni_neighbor_device(
        torch.as_tensor(children), torch.as_tensor(lengths), torch.as_tensor(edge),
        torch.as_tensor(variant), n_leaves)
    for b in range(3):
        want_c, want_l = jax_moves.nni_neighborhood_device(
            jnp.asarray(children[b]), jnp.asarray(lengths[b]), n_leaves)
        np.testing.assert_array_equal(got_c[b].numpy(), np.asarray(want_c))
        np.testing.assert_array_equal(got_l[b].numpy(), np.asarray(want_l))
        want_c, want_l = jax_moves.nni_neighbor_device(
            jnp.asarray(children[b]), jnp.asarray(lengths[b]), jnp.int32(edge[b]),
            jnp.int32(variant[b]), n_leaves)
        np.testing.assert_array_equal(one_c[b].numpy(), np.asarray(want_c))
        np.testing.assert_array_equal(one_l[b].numpy(), np.asarray(want_l))
    parents = tree_moves.parents_from_children(torch.as_tensor(children), n_leaves)
    for b in range(3):
        np.testing.assert_array_equal(
            parents[b].numpy(),
            np.asarray(jax_moves.parents_from_children(jnp.asarray(children[b]), n_leaves)))


def scan_case(seed, n_leaves, masks, gtr, chains=1):
    rng = np.random.default_rng(seed)
    n_all = 2 * n_leaves - 1
    children = random_children(rng, n_leaves, chains)
    lengths = rng.exponential(0.12, (chains, n_all)).astype(np.float32)
    lengths[:, -1] = 0.0
    high = 16 if masks else 4
    leaves = rng.integers(1 if masks else 0, high, size=(n_leaves, 160)).astype(np.int32)
    weights = np.random.default_rng(99).integers(0, 3, 160).astype(np.float32)
    return children, lengths, leaves, weights


def jax_models(lengths, gtr):
    if not gtr:
        return None, None
    eig = jax_eigensystem(jnp.asarray(GTR_RATES), jnp.asarray(GTR_FREQS))
    return jax.vmap(lambda t: jax_transition(t, *eig))(jnp.asarray(lengths)), \
        jnp.asarray(GTR_FREQS)


def torch_models(lengths, gtr):
    if not gtr:
        return None, None
    eig = gtr_eigensystem(torch.as_tensor(GTR_RATES), torch.as_tensor(GTR_FREQS))
    return gtr_pmats(torch.as_tensor(lengths), *eig), torch.as_tensor(GTR_FREQS)


@pytest.mark.parametrize("seed,n_leaves,masks,gtr,weighted",
                         [(0, 5, False, False, True), (1, 8, False, False, False),
                          (2, 12, True, False, True), (3, 9, False, True, True),
                          (4, 7, True, True, False)])
def test_nni_neighborhood_lnl_equals_jax(seed, n_leaves, masks, gtr, weighted):
    children, lengths, leaves, weights = scan_case(seed, n_leaves, masks, gtr, chains=2)
    pm, prior = torch_models(lengths, gtr)
    got = nni_scan.nni_neighborhood_lnl(
        torch.as_tensor(children), torch.as_tensor(lengths), torch.as_tensor(leaves), 4,
        transition_matrices=pm, root_prior=prior,
        site_weights=torch.as_tensor(weights) if weighted else None,
        sequences_are_masks=masks)
    assert got.shape == (2, 2 * (n_leaves - 2))
    for b in range(2):
        jpm, jprior = jax_models(lengths[b], gtr)
        want = jax_scan.nni_neighborhood_lnl(
            jnp.asarray(children[b]), jnp.asarray(lengths[b]), jnp.asarray(leaves), 4,
            transition_matrices=jpm, root_prior=jprior,
            site_weights=jnp.asarray(weights) if weighted else None,
            sequences_are_masks=masks)
        np.testing.assert_allclose(got[b].numpy(), np.asarray(want), rtol=2e-5)


@pytest.mark.parametrize("gtr,masks", [(False, False), (True, True)])
def test_tree_lnl_via_scan_equals_jax(gtr, masks):
    children, lengths, leaves, weights = scan_case(7, 10, masks, gtr, chains=3)
    pm, prior = torch_models(lengths, gtr)
    got = nni_scan.tree_lnl_via_scan(
        torch.as_tensor(children), torch.as_tensor(lengths), torch.as_tensor(leaves), 4,
        transition_matrices=pm, root_prior=prior, site_weights=torch.as_tensor(weights),
        sequences_are_masks=masks)
    for b in range(3):
        jpm, jprior = jax_models(lengths[b], gtr)
        want = jax_scan.tree_lnl_via_scan(
            jnp.asarray(children[b]), jnp.asarray(lengths[b]), jnp.asarray(leaves), 4,
            transition_matrices=jpm, root_prior=jprior, site_weights=jnp.asarray(weights),
            sequences_are_masks=masks)
        np.testing.assert_allclose(float(got[b]), float(want), rtol=2e-5)


def test_canonicalize_topology_permutes_lengths_as_jax():
    """``io.canonicalize_topology(children, lengths)`` returns the canonical
    children and the lengths carried to the new node numbers, as the JAX
    package's (the samplers canonicalize their pointer-swapped samples)."""
    from trex_tpu.io import canonicalize_topology as jax_canonicalize

    rng = np.random.default_rng(3)
    for n_leaves in (4, 9, 13):
        for tree in scrambled(rng, n_leaves, 3):
            lengths = rng.exponential(0.1, 2 * n_leaves - 1).astype(np.float32)
            got_c, got_l = canonicalize_topology(tree, lengths)
            want_c, want_l = jax_canonicalize(tree, lengths)
            np.testing.assert_array_equal(got_c, want_c)
            np.testing.assert_array_equal(got_l, want_l)
            assert canonicalize_topology(tree)[1] is None
