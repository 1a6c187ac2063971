"""Rerooting, pruning, leaf renumbering and the annotated newick writer of
``trex_tpu_torch.io`` against ``trex_tpu.io`` on the same trees."""

import numpy as np
import pytest
from _torch_parity import parents_of, random_children

import trex_tpu.io as jax_io
import trex_tpu_torch.io as tio
from trex_tpu.topology import Topology as JaxTopology
from trex_tpu_torch.search.bootstrap import subtree_leaf_sets
from trex_tpu_torch.topology import from_numpy

N_LEAVES = 9


@pytest.fixture(scope="module")
def trees():
    rng = np.random.default_rng(21)
    out = []
    for children in random_children(rng, N_LEAVES, 3):
        parents = parents_of(children)
        lengths = rng.random(2 * N_LEAVES - 1)
        out.append((from_numpy(children, parents),
                    JaxTopology(children=children, parents=parents), lengths))
    return out


def _same(ours, ref):
    np.testing.assert_array_equal(ours.children.numpy(), np.asarray(ref.children))
    np.testing.assert_array_equal(ours.parents.numpy(), np.asarray(ref.parents))


def _same_lengths(ours, ref):
    if ref is None:
        assert ours is None
    else:
        np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("with_lengths", [False, True])
def test_reroot_at_every_edge(trees, with_lengths):
    for topo, jax_topo, lengths in trees:
        blens = lengths if with_lengths else None
        for node in range(2 * N_LEAVES - 1):
            ours = tio.reroot_at_edge(topo, node, blens)
            ref = jax_io.reroot_at_edge(jax_topo, node, blens)
            _same(ours[0], ref[0])
            _same_lengths(ours[1], ref[1])


def test_reroot_on_outgroup(trees):
    for topo, jax_topo, lengths in trees:
        clades = subtree_leaf_sets(topo)
        every = frozenset(range(N_LEAVES))
        outgroups = [[3], sorted(clades[2]), sorted(every - clades[4])]
        for outgroup in outgroups:
            ours = tio.reroot_on_outgroup(topo, outgroup, lengths)
            ref = jax_io.reroot_on_outgroup(jax_topo, outgroup, lengths)
            _same(ours[0], ref[0])
            _same_lengths(ours[1], ref[1])
            assert frozenset(outgroup) in {
                frozenset(c) for c in subtree_leaf_sets(ours[0])
            } | {every - frozenset(c) for c in subtree_leaf_sets(ours[0])}
    topo = trees[0][0]
    for bad in ([], list(range(N_LEAVES)), [N_LEAVES]):
        with pytest.raises(ValueError):
            tio.reroot_on_outgroup(topo, bad)


def test_non_monophyletic_outgroup_raises(trees):
    topo, jax_topo, _ = trees[1]
    clades = {frozenset(c) for c in subtree_leaf_sets(topo)}
    every = frozenset(range(N_LEAVES))
    pair = next(
        [a, b] for a in range(N_LEAVES) for b in range(a + 1, N_LEAVES)
        if frozenset((a, b)) not in clades and every - frozenset((a, b)) not in clades
    )
    with pytest.raises(ValueError, match="monophyletic"):
        tio.reroot_on_outgroup(topo, pair)
    with pytest.raises(ValueError, match="monophyletic"):
        jax_io.reroot_on_outgroup(jax_topo, pair)


@pytest.mark.parametrize("keep", [[0, 1], [4, 2, 7], [8, 0, 3, 5, 1, 6]])
def test_prune_to_taxa(trees, keep):
    for topo, jax_topo, lengths in trees:
        for blens in (None, lengths):
            ours = tio.prune_to_taxa(topo, keep, blens)
            ref = jax_io.prune_to_taxa(jax_topo, keep, blens)
            _same(ours[0], ref[0])
            _same_lengths(ours[1], ref[1])
            assert ours[2] == ref[2]
    with pytest.raises(ValueError):
        tio.prune_to_taxa(trees[0][0], [1])
    with pytest.raises(ValueError):
        tio.prune_to_taxa(trees[0][0], [1, 1])


def test_renumber_leaves(trees):
    perm = np.random.default_rng(3).permutation(N_LEAVES).tolist()
    for topo, jax_topo, _ in trees:
        _same(tio.renumber_leaves(topo, perm), jax_io.renumber_leaves(jax_topo, perm))


def test_annotated_newick_writer(trees):
    names = [f"t'{i}" if i == 2 else f"taxon {i}" if i == 5 else f"t{i}"
             for i in range(N_LEAVES)]
    rng = np.random.default_rng(8)
    for topo, jax_topo, lengths in trees:
        numbers = rng.random(N_LEAVES - 1)
        labels = [f"{int(x * 100)}/{x:.3f}" for x in numbers]
        labels[3] = ""
        for kwargs in (
            dict(support=numbers),
            dict(support=labels),
            dict(support=np.round(numbers, 2), branch_lengths=lengths),
            dict(branch_lengths=lengths),
            dict(),
        ):
            for leaf_names in (names, None):
                assert tio.save_newick(topo, leaf_names, **kwargs) == jax_io.save_newick(
                    jax_topo, leaf_names, **kwargs)
        text = tio.save_newick(topo, names, branch_lengths=lengths, support=numbers)
        back, back_lengths, back_names = tio.load_newick(text)
        ref_back = jax_io.load_newick(text)
        assert back_names == ref_back[2] and sorted(back_names) == sorted(names)
        _same(back, ref_back[0])
        np.testing.assert_array_equal(back_lengths, ref_back[1])
