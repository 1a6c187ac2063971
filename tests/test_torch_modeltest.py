"""Model selection on the CPU against the JAX package: ``count_parameters``
over the model grammar, and ``modeltest --iterations 20`` against the JAX
CLI (the same keys, order, ranking and parameter counts; each fit's
log-likelihood, and so its AIC, AICc and BIC, within rtol 1e-4, slice
2b's rule for a fit's final loss)."""

import contextlib
import io
import json

import numpy as np
import pytest
from _torch_parity import tree_fasta

import trex_tpu.cli as jax_cli
import trex_tpu.search.model_select as jax_select
import trex_tpu_torch.cli as torch_cli
import trex_tpu_torch.search.model_select as torch_select

MODELS = ["jc", "jc+g", "k80+i", "hky", "hky+g+i", "f81+r2", "tn93+g", "gtr", "gtr+g+i",
          "gtr+r3", "empirical", "empirical+r8"]


@pytest.mark.parametrize("n_states, n_leaves", [(4, 10), (20, 7)])
def test_count_parameters_matches_jax(n_states, n_leaves):
    for model in MODELS:
        for fitted in (False, True):
            assert torch_select.count_parameters(model, n_states, n_leaves, fitted) == \
                jax_select.count_parameters(model, n_states, n_leaves, fitted), model
    for bad in ("gtr+r9", "jc+i+g", "lg"):
        with pytest.raises(ValueError, match="unknown model"):
            torch_select.count_parameters(bad, n_states, n_leaves)


def _run(cli, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    return json.loads(buf.getvalue())


def test_modeltest_matches_jax(tmp_path):
    fasta = tmp_path / "aln.fasta"
    fasta.write_text(tree_fasta(np.random.default_rng(5), 8, 120, 0.3))
    tree = tmp_path / "tree.nwk"
    tree.write_text(
        "((taxon_0,(taxon_5,taxon_2)),((taxon_7,taxon_1),(taxon_3,(taxon_4,taxon_6))));")
    argv = ["modeltest", "--alignment", str(fasta), "--tree", str(tree), "--models",
            "jc,gtr+g", "--iterations", "20"]
    ours = _run(torch_cli, [*argv, "--device", "cpu"])
    ref = _run(jax_cli, argv)
    assert list(ours) == list(ref)
    assert {k: ours[k] for k in ("criterion", "best", "n_taxa", "n_sites")} == {
        k: ref[k] for k in ("criterion", "best", "n_taxa", "n_sites")}
    assert [row["model"] for row in ours["table"]] == [row["model"] for row in ref["table"]]
    for row, ref_row in zip(ours["table"], ref["table"], strict=True):
        assert list(row) == list(ref_row)
        assert row["n_parameters"] == ref_row["n_parameters"]
        for key in ("log_likelihood", "aic", "aicc", "bic"):
            np.testing.assert_allclose(row[key], ref_row[key], rtol=1e-4, err_msg=key)
    with pytest.raises(ValueError, match="criterion"):
        torch_select.compare_models(None, np.zeros((2, 2), np.int32), 4, criterion="cv")


def test_compare_models_times_each_fit():
    """``timings`` receives every model's fit wall, keyed by the model."""
    import torch

    from trex_tpu_torch.topology import from_numpy

    topo = from_numpy(np.array([[0, 1], [2, 3], [4, 5]], np.int32),
                      np.array([4, 4, 5, 5, 6, 6, 6], np.int32))
    leaves = torch.as_tensor(np.random.default_rng(3).integers(0, 4, (4, 12), np.int32))
    timings = {}
    fits = torch_select.compare_models(topo, leaves, 4, models=("jc", "k80"), n_iterations=2,
                                       timings=timings)
    assert sorted(timings) == ["jc", "k80"] == sorted(f.model for f in fits)
    assert all(t > 0 for t in timings.values())
