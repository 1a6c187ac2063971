"""The port's ``score`` and ``bench`` commands (``--device cpu``) against
``trex_tpu.cli``'s, and the generated-data contract of
``models.mutation_tree``.

The port's generator draws other random bits than JAX's threefry, so
generated data is held to the contract, and the JAX package's
``sankoff_reconstruct`` is run on the port's own leaves. Scores are exact.
"""

import contextlib
import io
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import random_children, tree_fasta

import trex_tpu.cli as jax_cli
import trex_tpu_torch.cli as torch_cli
from trex_tpu.ops.dispatch import batched_scores_fastest as jax_dispatch
from trex_tpu.ops.sankoff import sankoff_reconstruct as jax_reconstruct
from trex_tpu.topology import Topology as JaxTopology
from trex_tpu.topology import balanced_topology as jax_balanced
from trex_tpu.types import CostModel as JaxCostModel
from trex_tpu_torch.cli.search_cmds import bench_inputs, run_bench
from trex_tpu_torch.io.fallback import py_write_newick
from trex_tpu_torch.models.mutation_tree import generate_groundtruth
from trex_tpu_torch.topology import balanced_adjacency


def _run(cli, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    return json.loads(buf.getvalue())


@pytest.mark.parametrize("n_states, n_mutations", [(4, 3), (20, 5)])
def test_groundtruth_meets_the_contract(n_states, n_mutations):
    n_leaves, length = 16, 64
    gt = generate_groundtruth(n_leaves, n_states, n_mutations, length, seed=3, device="cpu")
    seqs = gt.all_sequences.numpy()
    assert gt.all_sequences.dtype == gt.masked_sequences.dtype == torch.float32
    assert (seqs[-1] == 0).all() and seqs.min() >= 0 and seqs.max() < n_states
    for a in range(n_leaves - 1):  # ancestor n_leaves + a has children 2a, 2a + 1
        for child in (2 * a, 2 * a + 1):
            assert int((seqs[child] != seqs[n_leaves + a]).sum()) == n_mutations
    np.testing.assert_array_equal(gt.masked_sequences.numpy()[:n_leaves], seqs[:n_leaves])
    assert (gt.masked_sequences.numpy()[n_leaves:] == 0).all()
    np.testing.assert_array_equal(gt.adjacency.numpy(), balanced_adjacency(n_leaves).numpy())
    again = generate_groundtruth(
        n_leaves, n_states, n_mutations, length, seed=3, device="cpu"
    )
    assert torch.equal(again.all_sequences, gt.all_sequences)


def test_groundtruth_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        generate_groundtruth(4, 4, 1, 8, seed=0)


def test_score_generated_matches_jax_reconstruction():
    n_leaves, states = 16, 4
    ours = _run(torch_cli, [
        "score", "--leaves", str(n_leaves), "--sites", "64", "--states", str(states),
        "--seed", "2", "--device", "cpu",
    ])
    gt = generate_groundtruth(n_leaves, states, 3, 64, seed=2, device="cpu")
    truth = gt.all_sequences.numpy()
    recon, _, score = jax_reconstruct(
        jax_balanced(n_leaves), JaxCostModel.hamming(states).matrix,
        jnp.asarray(truth[:n_leaves].astype(np.int32)),
    )
    assert list(ours) == ["parsimony_score", "ancestor_identity_vs_truth"]
    assert ours["parsimony_score"] == float(score)
    matches = recon[n_leaves:] == jnp.asarray(truth[n_leaves:])
    # The same count of matching ancestral states; the float32 mean itself
    # may differ in its last bit (XLA divides by multiplying with 1/n).
    assert round(ours["ancestor_identity_vs_truth"] * matches.size) == int(matches.sum())
    assert ours["ancestor_identity_vs_truth"] == pytest.approx(float(jnp.mean(matches)), rel=1e-6)


@pytest.fixture(scope="module")
def alignment(tmp_path_factory):
    root = tmp_path_factory.mktemp("score")
    fasta = root / "aln.fasta"
    fasta.write_text(tree_fasta(np.random.default_rng(6), 12, 80, 0.3))
    children = random_children(np.random.default_rng(7), 12, 1)[0]
    # Leaves appear in another order than the FASTA rows; one label quoted.
    names = [f"taxon_{t}" for t in np.random.default_rng(8).permutation(12)]
    tree = py_write_newick(children, names).replace("taxon_3", "'taxon_3'")
    newick = root / "tree.nwk"
    newick.write_text("[a comment]" + tree + "\n")
    return str(fasta), str(newick)


@pytest.mark.parametrize("with_tree", [False, True])
def test_score_alignment_matches_jax(alignment, with_tree, tmp_path):
    fasta, newick = alignment
    argv = ["score", "--alignment", fasta] + (["--tree", newick] if with_tree else [])
    ours = _run(torch_cli, argv + ["--device", "cpu", "--output-fasta", str(tmp_path / "a.fa")])
    ref = _run(jax_cli, argv + ["--output-fasta", str(tmp_path / "b.fa")])
    assert list(ours) == list(ref)
    assert ours["parsimony_score"] == ref["parsimony_score"] > 0
    assert {k: v for k, v in ours.items() if k != "output_fasta"} == {
        k: v for k, v in ref.items() if k != "output_fasta"
    }
    assert (tmp_path / "a.fa").read_text() == (tmp_path / "b.fa").read_text()


def test_score_ml_names_its_slice(alignment):
    """``score --criterion ml`` is ported (slice 2b): JC69 lengths by Adam,
    marginal ancestors, the JAX command's keys
    (``tests/test_torch_ml_score_cli.py`` holds the values to JAX's)."""
    out = _run(torch_cli, ["score", "--alignment", alignment[0], "--criterion", "ml",
                           "--device", "cpu"])
    assert list(out)[3:] == ["log_likelihood", "mean_branch_length", "mean_ancestor_posterior"]
    assert out["log_likelihood"] < 0 and 0 < out["mean_ancestor_posterior"] <= 1


@pytest.mark.parametrize("states", [61, 4])
def test_bench_matches_jax_dispatch(states):
    argv = ["bench", "--leaves", "12", "--sites", "40", "--states", str(states),
            "--batch", "6", "--reps", "1", "--seed", "4"]
    ours = _run(torch_cli, argv + ["--device", "cpu"])
    ref = _run(jax_cli, argv)
    assert list(ours) == list(ref)
    assert (ours["metric"], ours["unit"], ours["batch"]) == (ref["metric"], ref["unit"], ref["batch"])
    assert ours["value"] > 0 and ours["ms_per_batch"] > 0
    args = torch_cli.build_parser().parse_args(argv + ["--device", "cpu"])
    topos, cost, leaves = bench_inputs(args, torch.device("cpu"))
    _, scores = run_bench(args)
    want = jax_dispatch(
        JaxTopology(jnp.asarray(topos.children.numpy()), jnp.asarray(topos.parents.numpy())),
        jnp.asarray(cost.numpy()), jnp.asarray(leaves.numpy()),
    )
    np.testing.assert_array_equal(scores.numpy(), np.asarray(want))
