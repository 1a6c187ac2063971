"""Distance trees on the CPU against the JAX package: ``ops/distances.py``'s
matrices (rtol 1e-6), NJ and UPGMA (the same trees, lengths within 1e-6),
``nj_bootstrap`` under JAX's replicate weights (the same supports), and
``infer --criterion distance`` (with ``--bootstrap``, ``--outgroup``,
``--start upgma``) and ``infer --start nj`` against the JAX CLI.

The alignments are evolved down random trees at a rate that leaves no two
pairs at equal distance, so NJ's argmin has no ties to resolve.
"""

import contextlib
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import (
    evolved_masks,
    integer_weights,
    jax_replicate_draws,
    jitted_jax_scores,
    lengths_of,
    random_children,
    strip_lengths,
    tree_fasta,
)

import trex_tpu.cli as jax_cli
import trex_tpu.ops.distances as jax_distances
import trex_tpu.search.bootstrap as jax_bootstrap
import trex_tpu.search.nj as jax_nj
import trex_tpu_torch.cli as torch_cli
import trex_tpu_torch.ops.distances as torch_distances
import trex_tpu_torch.search.nj as torch_nj


@pytest.fixture(scope="module")
def aln():
    rng = np.random.default_rng(3)
    masks = evolved_masks(rng, random_children(rng, 12, 1)[0], 80, 0.3)
    return np.log2(masks).astype(np.int32), integer_weights(rng, 80)


@pytest.mark.parametrize("fn", ["hamming_distance_matrix", "p_distance_matrix",
                                "jc_distance_matrix"])
@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
def test_distance_matrices_match_jax(aln, fn, weighted):
    ints, w = aln
    w = w if weighted else None
    ref = np.asarray(getattr(jax_distances, fn)(jnp.asarray(ints), 4,
                                                None if w is None else jnp.asarray(w)))
    got = getattr(torch_distances, fn)(torch.as_tensor(ints), 4,
                                       None if w is None else torch.as_tensor(w))
    assert got.dtype == torch.float32 and got.shape == (12, 12)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6)
    # A leading axis of weight vectors: each matrix as the one-vector call.
    if weighted:
        stacked = getattr(torch_distances, fn)(torch.as_tensor(ints), 4,
                                               torch.as_tensor(np.stack([w, w[::-1]])))
        assert torch.equal(stacked[0], got)
        np.testing.assert_allclose(stacked[1].numpy(), np.asarray(getattr(jax_distances, fn)(
            jnp.asarray(ints), 4, jnp.asarray(w[::-1].copy()))), rtol=1e-6)


@pytest.mark.parametrize("method", ["nj", "upgma"])
def test_distance_trees_match_jax(aln, method):
    ints, w = aln
    d = np.asarray(jax_distances.jc_distance_matrix(jnp.asarray(ints), 4, jnp.asarray(w)))
    build = {"nj": "neighbor_joining", "upgma": "upgma"}[method]
    ref_topo, ref_lengths = getattr(jax_nj, build)(d)
    topo, lengths = getattr(torch_nj, build)(d)
    assert np.array_equal(topo.children.numpy(), np.asarray(ref_topo.children))
    assert np.array_equal(topo.parents.numpy(), np.asarray(ref_topo.parents))
    np.testing.assert_array_equal(lengths, ref_lengths)
    # From the alignment: the port's matrix, then the same agglomeration.
    ref_topo, ref_lengths = jax_nj.nj_start_tree(ints, 4, jnp.asarray(w), method=method)
    topo, lengths = torch_nj.nj_start_tree(ints, 4, w, method=method, device="cpu")
    assert np.array_equal(topo.children.numpy(), np.asarray(ref_topo.children))
    np.testing.assert_allclose(lengths, ref_lengths, atol=1e-6)


def test_neighbor_joining_refuses_bad_input():
    with pytest.raises(ValueError, match="square"):
        torch_nj.neighbor_joining(np.zeros((3, 2)))
    with pytest.raises(ValueError, match="2 taxa"):
        torch_nj.upgma(np.zeros((1, 1)))


@pytest.mark.parametrize("method", ["nj", "upgma"])
def test_nj_bootstrap_matches_jax(aln, method):
    ints, w = aln
    key = jax.random.PRNGKey(4)
    ref_topo, ref_lengths, ref_support = jax_nj.nj_bootstrap(
        key, ints, 4, n_replicates=6, method=method, site_weights=jnp.asarray(w))
    draws = np.array(jax_bootstrap._replicate_weights(key, 80, 6, jnp.asarray(w)))
    timings = {}
    topo, lengths, support = torch_nj.nj_bootstrap(
        ints, 4, n_replicates=6, method=method, site_weights=w, replicate_weights=draws,
        device="cpu", timings=timings)
    assert np.array_equal(topo.children.numpy(), np.asarray(ref_topo.children))
    np.testing.assert_allclose(lengths, ref_lengths, atol=1e-6)
    np.testing.assert_array_equal(support, ref_support)
    assert 0.0 < support.min() < 1.0  # the replicates disagree somewhere
    assert set(timings) == {"reference", "distances", "agglomerate"}


def _run(cli, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    return json.loads(buf.getvalue())


@pytest.fixture(scope="module")
def fasta(tmp_path_factory):
    path = tmp_path_factory.mktemp("aln") / "aln.fasta"
    path.write_text(tree_fasta(np.random.default_rng(8), 12, 90, 0.3))
    return str(path)


@pytest.mark.parametrize("flags", [
    ["--criterion", "distance"],
    ["--criterion", "distance", "--start", "upgma", "--bootstrap", "4"],
    ["--criterion", "distance", "--bootstrap", "4", "--outgroup", "taxon_3"],
    ["--start", "nj", "--neighborhood", "nni"],
], ids=["distance", "upgma_bootstrap", "bootstrap_outgroup", "start_nj"])
def test_infer_distance_flags_match_jax(fasta, flags, monkeypatch):
    """The port's CLI against the JAX CLI: the same keys in the same order,
    the same tree (lengths within 1e-6) and, for the bootstrap, the same
    supports under the JAX CLI's draws (its key ``PRNGKey(--seed)``)."""
    jitted_jax_scores(monkeypatch)
    jax_replicate_draws(monkeypatch, 0)
    ours = _run(torch_cli, ["infer", "--alignment", fasta, "--device", "cpu", *flags])
    ref = _run(jax_cli, ["infer", "--alignment", fasta, "--mesh", "1,1", *flags])
    assert list(ours) == list(ref)
    assert strip_lengths(ours["tree"]) == strip_lengths(ref["tree"])
    np.testing.assert_allclose(lengths_of(ours["tree"]), lengths_of(ref["tree"]), atol=1e-6)
    for key, value in ref.items():
        if key == "tree_length":
            np.testing.assert_allclose(ours[key], value, rtol=1e-6)
        elif key != "tree":
            assert ours[key] == value, key
