"""End to end: ``trex_tpu_torch.cli infer --criterion ml --device cpu`` against
``trex_tpu.cli infer --criterion ml --mesh 1,1`` on the same FASTA, plus the
ML search's refusals of what is not ported.

Same JSON keys in the same order, the same topology and ``search_rounds``;
log-likelihoods within rtol 2e-5 (float32 sums in another order) and branch
lengths within atol 1e-3 (Newton steps taken from those sums).
"""

import contextlib
import io
import json
import re

import numpy as np
import pytest
import torch
from _torch_parity import parents_of, random_masks, tree_fasta

import trex_tpu.cli as jax_cli
import trex_tpu_torch.cli as torch_cli
from trex_tpu_torch.search.hillclimb import parsimony_hill_climb
from trex_tpu_torch.search.ml import ml_hill_climb
from trex_tpu_torch.topology import from_numpy

_LENGTH = re.compile(r":([0-9.eE+-]+)")


def _run(cli, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    return json.loads(buf.getvalue())


@pytest.fixture(scope="module")
def fasta(tmp_path_factory):
    path = tmp_path_factory.mktemp("aln") / "aln.fasta"
    # 10 taxa: both climbs still take rounds, and the JAX CLI's compile
    # time, most of this file's, stays small.
    path.write_text(tree_fasta(np.random.default_rng(5), 10, 60, 0.5))
    return str(path)


@pytest.mark.parametrize("neighborhood", ["spr-scan", "nni"])
def test_ml_infer_matches_jax(fasta, neighborhood, tmp_path):
    out_tree = tmp_path / "tree.nwk"
    ours = _run(torch_cli, [
        "infer", "--alignment", fasta, "--device", "cpu", "--criterion", "ml",
        "--neighborhood", neighborhood, "--output-tree", str(out_tree),
    ])
    ref = _run(jax_cli, [
        "infer", "--alignment", fasta, "--mesh", "1,1", "--criterion", "ml",
        "--neighborhood", neighborhood,
    ])
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
    np.testing.assert_allclose(ours["mean_branch_length"], ref["mean_branch_length"], atol=1e-3)
    assert out_tree.read_text() == ours["tree"] + "\n"


def _start(seed=0, n=7, length=40):
    from _torch_parity import random_children

    rng = np.random.default_rng(seed)
    children = random_children(rng, n, 1)[0]
    return from_numpy(children, parents_of(children)), random_masks(rng, n, length)


@pytest.mark.parametrize(
    "kwargs, error, match",
    [
        (dict(neighborhood="spr"), NotImplementedError, "slice 1b"),
        (dict(neighborhood="tbr"), NotImplementedError, "slice 1b"),
        (dict(neighborhood="nni", length_optimizer="adam"), NotImplementedError, "later slice"),
        (dict(neighborhood="spr-scan", gamma_shape=0.5), NotImplementedError, "model-fitting slice"),
        (dict(neighborhood="spr-scan", category_rates=np.ones(2)), NotImplementedError,
         "model-fitting slice"),
    ],
)
def test_ml_hill_climb_refuses_what_is_not_ported(kwargs, error, match):
    start, masks = _start()
    with pytest.raises(error, match=match):
        ml_hill_climb(start, masks, 4, sequences_are_masks=True, device="cpu", **kwargs)


def test_gtr_nni_climb_ranks_with_the_model():
    start, masks = _start(1, n=8, length=60)
    rng = np.random.default_rng(2)
    rates = np.abs(rng.normal(1.0, 0.4, (4, 4))).astype(np.float32)
    freqs = rng.dirichlet(np.full(4, 3.0)).astype(np.float32)
    result, lengths, losses = ml_hill_climb(
        start, torch.as_tensor(masks), 4, neighborhood="nni", max_rounds=5,
        sequences_are_masks=True, rates=(rates + rates.T) / 2, freqs=freqs,
    )
    assert result.trace == sorted(result.trace, reverse=True)
    assert torch.isfinite(lengths).all() and float(losses[-1]) <= float(losses[0])
    assert result.score == pytest.approx(result.trace[-1])


@pytest.mark.parametrize("optimize_final_lengths", [True, False])
def test_ml_hill_climb_reports_its_timings(optimize_final_lengths):
    start, masks = _start(3, n=6, length=30)
    timings = {}
    result, lengths, losses = ml_hill_climb(
        start, torch.as_tensor(masks), 4, neighborhood="nni", max_rounds=2,
        sequences_are_masks=True, optimize_final_lengths=optimize_final_lengths,
        timings=timings,
    )
    assert sorted(timings) == ["climb", "newton"]
    assert all(t >= 0.0 for t in timings.values())
    assert torch.isfinite(lengths).all() and len(lengths) == start.n_all
    if not optimize_final_lengths:
        assert float(losses[-1]) == pytest.approx(result.score)


def test_scan_climb_refuses_a_custom_scorer():
    start, masks = _start()
    with pytest.raises(ValueError, match="score_batch_fn"):
        parsimony_hill_climb(
            start, torch.zeros((4, 4)), masks, neighborhood="spr-scan",
            score_batch_fn=lambda *a: None, device="cpu",
        )
