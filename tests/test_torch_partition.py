"""Partitioned models on the CPU against the JAX package:
``io.parse_partitions`` (ranges, several segments, single sites, strides,
comments, and the same errors) and ``optimize_model_partitioned`` in both
``linked`` modes, held as slice 2b holds the fits: the first 20 losses
within rtol 1e-5, the last within 1e-4, the fitted parameters, lengths,
multipliers and per-partition log-likelihoods within 1e-2; and the
``partition`` command against the JAX CLI. The port prunes each
partition over its own columns, JAX every site under a zeroed mask: the
same sums in another order."""

import contextlib
import io
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import (
    evolved_masks,
    lengths_of,
    parents_of,
    random_children,
    strip_lengths,
    tree_fasta,
)

import trex_tpu.cli as jax_cli
import trex_tpu.io as jax_io
import trex_tpu.ops.likelihood as jax_likelihood
import trex_tpu_torch.cli as torch_cli
import trex_tpu_torch.io as torch_io
import trex_tpu_torch.ops.likelihood as torch_likelihood
from trex_tpu.topology import Topology as JaxTopology
from trex_tpu_torch.topology import from_numpy

PARTITION_TEXTS = {
    "ranges": ("DNA, gene1 = 1-10\nDNA, gene2 = 11-24\n", 24),
    "segments": ("DNA, a = 1-5, 11-15  # two pieces\n\n// note\nWAG, b = 6-10, 16-24\n", 24),
    "strides": ("DNA, codon12 = 1-24\\3, 2-24\\3\nDNA, codon3 = 3-24\\3\n", 24),
    "single": ("DNA, one = 7\nDNA, rest = 1-6, 8-12\n", 12),
}


@pytest.mark.parametrize("name", sorted(PARTITION_TEXTS))
def test_parse_partitions_matches_jax(name):
    text, n_sites = PARTITION_TEXTS[name]
    ids, names, types = torch_io.parse_partitions(text, n_sites)
    ref_ids, ref_names, ref_types = jax_io.parse_partitions(text, n_sites)
    assert ids.dtype == np.int32
    np.testing.assert_array_equal(ids, ref_ids)
    assert (names, types) == (ref_names, ref_types)


@pytest.mark.parametrize("text", [
    "DNA gene1 = 1-10\n",
    "DNA, gene1 1-10\n",
    "DNA, a = 0-5\n",
    "DNA, a = 1-13\n",
    "DNA, a = 1-8\nDNA, b = 8-12\n",
    "DNA, a = 1-10\n",
])
def test_parse_partitions_errors_match_jax(text):
    with pytest.raises(ValueError) as ref:
        jax_io.parse_partitions(text, 12)
    with pytest.raises(ValueError) as ours:
        torch_io.parse_partitions(text, 12)
    assert str(ours.value) == str(ref.value)


@pytest.mark.parametrize("linked", ["proportional", "equal"])
def test_optimize_model_partitioned_matches_jax(linked):
    rng = np.random.default_rng(7)
    masks = evolved_masks(rng, random_children(rng, 8, 1)[0], 60, 0.3)
    # The second gene evolves twice as fast.
    masks[:, 30:] = evolved_masks(rng, random_children(rng, 8, 1)[0], 30, 0.6)
    children = random_children(rng, 8, 1)[0]
    parents = parents_of(children)
    pids = np.repeat(np.arange(2, dtype=np.int32), 30)
    kwargs = dict(models=["gtr", "hky"], linked=linked, n_iterations=30,
                  sequences_are_masks=True)
    ref, ref_losses = jax_likelihood.optimize_model_partitioned(
        JaxTopology(jnp.asarray(children), jnp.asarray(parents)), jnp.asarray(masks), 4,
        jnp.asarray(pids), **kwargs)
    ours, losses = torch_likelihood.optimize_model_partitioned(
        from_numpy(children, parents), torch.as_tensor(masks), 4, pids, **kwargs)
    ref_losses = np.asarray(ref_losses)
    np.testing.assert_allclose(losses.numpy()[:20], ref_losses[:20], rtol=1e-5)
    np.testing.assert_allclose(losses.numpy()[-1], ref_losses[-1], rtol=1e-4)
    assert losses[-1] < losses[0]
    np.testing.assert_allclose(ours["branch_lengths"].numpy(),
                               np.asarray(ref["branch_lengths"]), rtol=1e-2)
    np.testing.assert_allclose(ours["rate_multipliers"].numpy(),
                               np.asarray(ref["rate_multipliers"]), rtol=1e-2)
    if linked == "equal":
        assert ours["rate_multipliers"].tolist() == [1.0, 1.0]
    for part, ref_part in zip(ours["partitions"], ref["partitions"], strict=True):
        assert set(part) == set(ref_part)
        for key, value in ref_part.items():
            np.testing.assert_allclose(part[key].numpy(), np.asarray(value), rtol=1e-2,
                                       err_msg=key)


def test_optimize_model_partitioned_refusals():
    topo = from_numpy(random_children(np.random.default_rng(0), 4, 1)[0],
                      parents_of(random_children(np.random.default_rng(0), 4, 1)[0]))
    masks = torch.ones((4, 6), dtype=torch.int32)
    pids = np.array([0, 0, 0, 1, 1, 1])
    with pytest.raises(ValueError, match="linked"):
        torch_likelihood.optimize_model_partitioned(topo, masks, 4, pids, models=["jc", "jc"],
                                                    linked="free")
    with pytest.raises(ValueError, match="2 partitions but 1"):
        torch_likelihood.optimize_model_partitioned(topo, masks, 4, pids, models=["jc"])
    with pytest.raises(ValueError, match="fixed_rates"):
        torch_likelihood.optimize_model_partitioned(topo, masks, 4, pids,
                                                    models=["jc", "empirical"])


def _run(cli, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    return json.loads(buf.getvalue())


def test_partition_command(tmp_path):
    """``partition --search`` against the JAX CLI on the same FASTA and
    partition file: the stepwise start, the column split, the fitted
    models handed to the summed scans and the refit after the climb moved
    the tree. The same keys in the same order, ``search_rounds`` and tree;
    the log-likelihoods within rtol 1e-4 and the multipliers, shapes,
    frequencies, tree length and branch lengths within rtol 1e-2 (slice
    2b's rule for a fit's last loss and its parameters)."""
    from trex_tpu_torch.cli.models import run_partition

    fasta = tmp_path / "aln.fasta"
    fasta.write_text(tree_fasta(np.random.default_rng(5), 8, 60, 0.4))
    parts_file = tmp_path / "parts.txt"
    parts_file.write_text("DNA, gene1 = 1-30\nDNA, gene2 = 31-60\n")
    argv = ["partition", "--alignment", str(fasta), "--partitions", str(parts_file),
            "--models", "gtr,hky+g", "--iterations", "20", "--search"]
    ours = _run(torch_cli, [*argv, "--output-tree", str(tmp_path / "ours.nwk"),
                            "--device", "cpu"])
    ref = _run(jax_cli, [*argv, "--output-tree", str(tmp_path / "ref.nwk")])
    assert list(ours) == list(ref) == ["n_taxa", "n_sites", "linked", "log_likelihood",
                                       "tree_length", "partitions", "search_rounds",
                                       "output_tree"]
    for key in ("n_taxa", "n_sites", "linked", "search_rounds"):
        assert ours[key] == ref[key], key
    assert ours["search_rounds"] > 0
    ours_tree, ref_tree = ((tmp_path / f).read_text() for f in ("ours.nwk", "ref.nwk"))
    assert strip_lengths(ours_tree) == strip_lengths(ref_tree)
    np.testing.assert_allclose(lengths_of(ours_tree), lengths_of(ref_tree), rtol=1e-2)
    np.testing.assert_allclose(ours["log_likelihood"], ref["log_likelihood"], rtol=1e-4)
    np.testing.assert_allclose(ours["tree_length"], ref["tree_length"], rtol=1e-2)
    assert [p["name"] for p in ours["partitions"]] == ["gene1", "gene2"]
    for part, ref_part in zip(ours["partitions"], ref["partitions"], strict=True):
        assert list(part) == list(ref_part)
        for key in ("name", "type", "model", "n_sites"):
            assert part[key] == ref_part[key], key
        np.testing.assert_allclose(part["log_likelihood"], ref_part["log_likelihood"],
                                   rtol=1e-4)
        for key in ("rate_multiplier", "gamma_shape", "frequencies"):
            if key in ref_part:
                np.testing.assert_allclose(part[key], ref_part[key], rtol=1e-2, err_msg=key)
    timings = {}
    args = torch_cli.build_parser().parse_args([*argv, "--device", "cpu"])
    assert run_partition(args, timings)["search_rounds"] == ours["search_rounds"]
    assert len(timings["fits"]) == 2 and "scan_rounds" in timings
