"""``simulate --model gy94`` then ``dnds`` on the CPU against the JAX CLI,
at the command's defaults (the stepwise start on the nucleotide masks,
F3x4, GY94; 30 Adam steps): the JAX command's keys in its order, the counts and tree source
equal, kappa and omega within 1e-2, the log-likelihood
within rtol 1e-4 and the tree length within 1e-2 (the fits' tolerances:
torch's ``matrix_exp`` against JAX's ``expm``, Adam's bias corrections)."""

import contextlib
import io
import json

import numpy as np

import trex_tpu.cli as jax_cli
import trex_tpu_torch.cli as torch_cli


def _run(cli, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        cli.main(argv)
    return out.getvalue()


def _codons(tmp_path, leaves):
    """A GY94 codon alignment (80 codons) and its true tree, from the port's
    ``simulate``."""
    aln, tree = str(tmp_path / "codons.fasta"), str(tmp_path / "true.nwk")
    _run(torch_cli, ["simulate", "--model", "gy94", "--leaves", str(leaves), "--sites", "80",
                     "--seed", "2", "--kappa", "3.0", "--omega", "0.3", "--default-blen",
                     "0.3", "--output", aln, "--output-tree", tree, "--device", "cpu"])
    seqs = [line for line in open(aln).read().splitlines() if not line.startswith(">")]
    assert len(seqs) == leaves and {len(s) for s in seqs} == {240}
    return aln, tree


def assert_same_dnds(argv):
    port = json.loads(_run(torch_cli, [*argv, "--device", "cpu"]))
    ref = json.loads(_run(jax_cli, argv))
    assert list(port) == list(ref)
    for key in ("model", "codon_frequencies", "tree_source", "n_taxa", "n_codons",
                "unique_codon_patterns", "missing_codons"):
        assert port[key] == ref[key], key
    for key in ("kappa", "omega", "gamma_shape"):
        if key in ref:
            np.testing.assert_allclose(port[key], ref[key], rtol=1e-2, err_msg=key)
    np.testing.assert_allclose(port["log_likelihood"], ref["log_likelihood"], rtol=1e-4)
    np.testing.assert_allclose(port["tree_length"], ref["tree_length"], rtol=1e-2)
    return port


def test_dnds_defaults_equal_jax(tmp_path):
    aln, _ = _codons(tmp_path, 6)
    out = assert_same_dnds(["dnds", "--alignment", aln, "--iterations", "30"])
    assert out["tree_source"] == "stepwise addition (nucleotide parsimony)"
