"""Parity of the port's host-side I/O and tree moves with trex_tpu.io."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import parents_of, random_children, tree_fasta

import trex_tpu.io as jio
from trex_tpu.alignment import compress_alignment as jax_compress
from trex_tpu.io.fallback import _canonicalize as jax_canonicalize
from trex_tpu.topology import Topology as JaxTopology
from trex_tpu_torch import io as tio
from trex_tpu_torch.alignment import compress_alignment
from trex_tpu_torch.io.fallback import _canonicalize
from trex_tpu_torch.topology import from_numpy


def _tree(seed, n_leaves=10):
    children = random_children(np.random.default_rng(seed), n_leaves, 1)[0]
    parents = parents_of(children)
    return (
        from_numpy(children, parents),
        JaxTopology(children=jnp.asarray(children), parents=jnp.asarray(parents)),
    )


def test_topology_numpy_round_trip():
    ours, ref = _tree(0)
    children, parents = ours.to_numpy()
    np.testing.assert_array_equal(children, np.asarray(ref.children))
    np.testing.assert_array_equal(parents, np.asarray(ref.parents))
    assert children.dtype == parents.dtype == np.int32
    assert ours.children.dtype == torch.int32
    assert (ours.n_leaves, ours.n_ancestors, ours.n_all) == (10, 9, 19)


@pytest.mark.parametrize("seed", [1, 2])
def test_spr_move_matches_jax_for_every_pair(seed):
    ours, ref = _tree(seed)
    for p in range(ours.n_all):
        for v in range(ours.n_all):
            a = tio.spr_move(ours, p, v)
            b = jio.spr_move(ref, p, v)
            assert (a is None) == (b is None), (p, v)
            if a is not None:
                np.testing.assert_array_equal(a.children.numpy(), np.asarray(b.children))
                np.testing.assert_array_equal(a.parents.numpy(), np.asarray(b.parents))


@pytest.mark.parametrize("seed", [3, 4])
def test_nni_neighbors_match_jax(seed):
    ours, ref = _tree(seed, n_leaves=12)
    for a, b in zip(tio.nni_neighbors_host(ours), jio.nni_neighbors_host(ref)):
        np.testing.assert_array_equal(a, b)


def test_save_newick_matches_jax():
    ours, ref = _tree(5)
    names = [f"t{i}" for i in range(9)] + ["needs quoting:'x'"]
    assert tio.save_newick(ours, names) == jio.save_newick(ref, names)
    assert tio.save_newick(ours) == jio.save_newick(ref)


def test_canonicalize_matches_jax_and_survives_deep_trees():
    # Shuffled ancestor numbering of a random tree: same canonical arrays.
    rng = np.random.default_rng(6)
    children = random_children(rng, 30, 1)[0]
    kids = {30 + a: [int(c) for c in children[a]] for a in range(29)}
    for x, y in zip(_canonicalize(30, kids, 58), jax_canonicalize(30, kids, 58)):
        if isinstance(x, dict):
            assert x == y
        else:
            np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(
        tio.canonicalize_topology(children), jio.canonicalize_topology(children)[0]
    )
    # A 5000-taxon caterpillar is far deeper than Python's recursion limit.
    n = 5000
    cat = {n: [0, 1]}
    cat.update({n + a: [n + a - 1, a + 1] for a in range(1, n - 1)})
    ch, par, _ = _canonicalize(n, cat, 2 * n - 2)
    assert (ch[:, 0] < ch[:, 1]).all() and (ch.max(axis=1) < np.arange(n, 2 * n - 1)).all()
    assert par[-1] == 2 * n - 2


@pytest.mark.parametrize("alphabet", ["dna", "protein"])
def test_parse_fasta_masks_matches_jax(alphabet):
    if alphabet == "dna":
        text = tree_fasta(np.random.default_rng(7), 6, 50, 0.2)
        alpha = tio.DNA
    else:
        text = ">a\nARND-CQ?\n>b desc\nEGHIXLKx\n>c\nmfpstw.V\n"
        alpha = tio.PROTEIN
    names, masks = tio.parse_fasta_masks(text, alpha)
    ref_names, ref_masks = jio.parse_fasta_masks(text, alpha)
    assert names == ref_names
    np.testing.assert_array_equal(masks, ref_masks)
    with pytest.raises(ValueError, match="not in the alphabet"):
        tio.parse_fasta_masks(">a\nAC!T\n", alpha)


def test_phylip_nexus_and_compression_match_jax():
    phylip = "3 8\nalpha ACGTRYN-\nbeta  ACGTACGT\ngamma AC GTTT?A\n"
    nexus = (
        "#NEXUS\nbegin data; dimensions ntax=2 nchar=5; format datatype=dna;\n"
        "matrix\n  one ACGTN [comment]\n  'two words' A.G-T\n;\nend;\n"
        "begin trees; translate 1 one, 2 'two words'; tree t1 = (1,2);\nend;\n"
    )
    for ours, ref in [
        (tio.parse_phylip(phylip), jio.parse_phylip(phylip)),
        (tio.parse_nexus(nexus), jio.parse_nexus(nexus)),
    ]:
        assert ours[0] == ref[0]
        np.testing.assert_array_equal(ours[1], ref[1])
        np.testing.assert_array_equal(
            tio.encode_alignment_masks(ours[1], tio.DNA),
            jio.encode_alignment_masks(ref[1], jio.DNA),
        )
    assert tio.parse_nexus(nexus)[2] == jio.parse_nexus(nexus)[2]
    masks = jio.encode_alignment_masks(jio.parse_phylip(phylip)[1], jio.DNA)
    for x, y in zip(compress_alignment(masks), jax_compress(masks)):
        np.testing.assert_array_equal(x, y)
