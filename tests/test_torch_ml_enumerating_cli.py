"""End to end: ``trex_tpu_torch.cli infer --criterion ml --neighborhood
spr|tbr --device cpu`` against ``trex_tpu.cli infer --criterion ml --mesh
1,1`` on the same FASTA: the enumerated neighbourhoods ranked by the
batched likelihood (K3 on the card), then the Newton length fit.

Same JSON keys in the same order, the same topology, ``search_rounds`` and
``evaluations``; log-likelihoods within rtol 2e-5 and branch lengths within
atol 1e-3, as ``test_torch_ml.py`` holds the nni and scan routes.
"""

import contextlib
import io
import json
import re

import jax
import numpy as np
import pytest
from _torch_parity import jitted_jax_scores, tree_fasta

import trex_tpu.cli as jax_cli
import trex_tpu.search.ml as jax_ml
import trex_tpu_torch.cli as torch_cli

_LENGTH = re.compile(r":([0-9.eE+-]+)")


def _run(cli, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    return json.loads(buf.getvalue())


@pytest.fixture(scope="module")
def fasta(tmp_path_factory):
    path = tmp_path_factory.mktemp("aln") / "aln.fasta"
    path.write_text(tree_fasta(np.random.default_rng(5), 10, 60, 0.5))
    return str(path)


@pytest.mark.parametrize("neighborhood", ["spr", "tbr"])
def test_ml_enumerating_infer_matches_jax(fasta, neighborhood, monkeypatch):
    # The JAX side's stepwise scoring and candidate likelihoods run jitted
    # (the same functions, compiled whole instead of op by op).
    jitted_jax_scores(monkeypatch)
    monkeypatch.setattr(jax_ml, "tree_log_likelihood", jax.jit(
        jax_ml.tree_log_likelihood, static_argnums=(3,),
        static_argnames=("sequences_are_masks",)))
    argv = ["infer", "--alignment", fasta, "--criterion", "ml", "--neighborhood", neighborhood]
    ours = _run(torch_cli, [*argv, "--device", "cpu"])
    ref = _run(jax_cli, [*argv, "--mesh", "1,1"])
    assert list(ours) == list(ref)
    assert ours["search_rounds"] > 0
    for key in ("criterion", "start", "n_taxa", "n_sites", "unique_patterns",
                "model", "search_rounds", "evaluations"):
        assert ours[key] == ref[key], key
    assert _LENGTH.sub("", ours["tree"]) == _LENGTH.sub("", ref["tree"])
    for key in ("neg_log_likelihood", "ranking_score"):
        np.testing.assert_allclose(ours[key], ref[key], rtol=2e-5)
    lengths = [float(x) for x in _LENGTH.findall(ours["tree"])]
    ref_lengths = [float(x) for x in _LENGTH.findall(ref["tree"])]
    np.testing.assert_allclose(lengths, ref_lengths, atol=1e-3)
