"""The iterated ML search and the constrained ML climb on the CPU against
the JAX package: ``ml_iterated_search`` from the same seed (its kicks are
numpy draws, so the tree, score, trace and evaluations are JAX's), its
``progress_dir`` resume in both directions (the port resumes from a
directory JAX wrote and JAX from one the port wrote), the constrained
``ml_hill_climb``, and ``infer --criterion ml`` with ``--ratchet`` (held
to JAX's ``ml_iterated_search`` under the CLI's key ``PRNGKey(--seed +
13)``; the JAX CLI's own ratchet takes minutes) and ``--constraint``
(against the JAX CLI).

The candidates are ranked on the CPU by K3's plain version, JAX by lax
(about 1e-7 relative apart): the alignments are evolved at a rate whose
best candidates lie further apart than that.
"""

import contextlib
import io
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import (
    evolved_masks,
    integer_weights,
    jitted_jax_scores,
    lengths_of,
    parents_of,
    random_children,
    strip_lengths,
    tree_fasta,
)

import trex_tpu.cli as jax_cli
import trex_tpu.search.ml as jax_ml
import trex_tpu_torch.cli as torch_cli
import trex_tpu_torch.search.ml as torch_ml
from trex_tpu.topology import Topology as JaxTopology
from trex_tpu_torch.topology import from_numpy


@pytest.fixture(autouse=True)
def _jitted(monkeypatch):
    """The JAX package's candidate likelihoods and stepwise scores jitted
    (the same functions, compiled whole instead of op by op)."""
    monkeypatch.setattr(jax_ml, "tree_log_likelihood", jax.jit(
        jax_ml.tree_log_likelihood, static_argnums=(3,),
        static_argnames=("sequences_are_masks",)))
    jitted_jax_scores(monkeypatch)


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(7)
    masks = evolved_masks(rng, random_children(rng, 10, 1)[0], 60, 0.3)
    weights = integer_weights(rng, 60)
    start = random_children(rng, 10, 1)[0]
    return masks, weights, start, parents_of(start)


def _same(ours, ref, ours_lengths=None, ref_lengths=None):
    assert np.array_equal(ours.topology.children.cpu().numpy(), np.asarray(ref.topology.children))
    np.testing.assert_allclose(ours.score, ref.score, rtol=2e-6)
    np.testing.assert_allclose(ours.trace, ref.trace, rtol=2e-6)
    assert (ours.rounds, ours.evaluations) == (ref.rounds, ref.evaluations)
    if ours_lengths is not None:
        np.testing.assert_allclose(ours_lengths.numpy(), np.asarray(ref_lengths), atol=1e-3)


def _iterated(package, start, case, n_iterations, progress_dir):
    masks, weights, _, _ = case
    kwargs = dict(n_iterations=n_iterations, max_rounds=4, neighborhood="nni",
                  sequences_are_masks=True, progress_dir=str(progress_dir))
    if package == "jax":
        return jax_ml.ml_iterated_search(
            jax.random.PRNGKey(5), JaxTopology(jnp.asarray(start[0]), jnp.asarray(start[1])),
            jnp.asarray(masks), 4, site_weights=jnp.asarray(weights), **kwargs)
    return torch_ml.ml_iterated_search(
        from_numpy(*start), torch.as_tensor(masks), 4, seed=5,
        site_weights=torch.as_tensor(weights), device="cpu", **kwargs)


def test_ml_iterated_search_and_resume_match_jax(case, tmp_path):
    start = case[2:]
    ref, ref_lengths, ref_losses = _iterated("jax", start, case, 3, tmp_path / "jax")
    timings = {}
    masks, weights, _, _ = case
    ours, lengths, losses = torch_ml.ml_iterated_search(
        from_numpy(*start), torch.as_tensor(masks), 4, seed=5, n_iterations=3, max_rounds=4,
        neighborhood="nni", sequences_are_masks=True, site_weights=torch.as_tensor(weights),
        progress_dir=str(tmp_path / "torch"), device="cpu", timings=timings)
    _same(ours, ref, lengths, ref_lengths)
    assert ours.trace[-1] < ours.trace[0]  # a kick found a better tree
    np.testing.assert_allclose(float(losses[-1]), float(ref_losses[-1]), rtol=2e-5)
    assert len(timings["reclimbs"]) == 3 and timings["newton"] > 0
    assert (tmp_path / "torch" / "best.nwk").read_text() == (
        tmp_path / "jax" / "best.nwk").read_text()
    traces = [[json.loads(line) for line in (tmp_path / d / "trace.jsonl").open()]
              for d in ("torch", "jax")]
    assert [t["iteration"] for t in traces[0]] == [t["iteration"] for t in traces[1]]
    np.testing.assert_allclose([t["score"] for t in traces[0]],
                               [t["score"] for t in traces[1]], rtol=2e-6)

    # Resume across packages from another start: each continues from the
    # other's best tree and appends to its trace.
    other = random_children(np.random.default_rng(1), 10, 1)[0]
    other = (other, parents_of(other))
    for writer, reader in (("jax", "torch"), ("torch", "jax")):
        shutil.copytree(tmp_path / writer, tmp_path / f"{writer}_again")
        resumed = _iterated(reader, other, case, 1, tmp_path / writer)
        again = _iterated(writer, other, case, 1, tmp_path / f"{writer}_again")
        ours, ref = (resumed, again) if reader == "torch" else (again, resumed)
        _same(ours[0], ref[0])
        # The first climb starts from the saved best tree, not from `other`.
        assert ours[0].trace[0] <= traces[0][-1]["score"] * (1 + 2e-6)
        assert len((tmp_path / writer / "trace.jsonl").read_text().splitlines()) == 4 + 2


def test_constrained_ml_climb_matches_jax(case):
    from trex_tpu.search.hillclimb import constrained_start as jax_constrained_start
    from trex_tpu.topology import balanced_topology as jax_balanced
    from trex_tpu_torch.search.hillclimb import constrained_start
    from trex_tpu_torch.topology import balanced_topology

    masks, weights, _, _ = case
    taxa = [0, 3, 5, 7]
    splits = [frozenset([0, 3])]
    ref_start = jax_constrained_start(jax_balanced(4), taxa, 10, seed=2)
    start = constrained_start(balanced_topology(4), taxa, 10, seed=2, device="cpu")
    ref, ref_lengths, _ = jax_ml.ml_hill_climb(
        ref_start, jnp.asarray(masks), 4, max_rounds=10, neighborhood="nni",
        sequences_are_masks=True, site_weights=jnp.asarray(weights),
        constraint_splits=splits, constraint_taxa=frozenset(taxa))
    ours, lengths, _ = torch_ml.ml_hill_climb(
        start, torch.as_tensor(masks), 4, max_rounds=10, neighborhood="nni",
        sequences_are_masks=True, site_weights=torch.as_tensor(weights),
        constraint_splits=splits, constraint_taxa=frozenset(taxa), device="cpu")
    _same(ours, ref, lengths, ref_lengths)
    assert ours.rounds > 0
    with pytest.raises(ValueError, match="enumerating"):
        torch_ml.ml_hill_climb(start, torch.as_tensor(masks), 4, neighborhood="spr-scan",
                               constraint_splits=splits, device="cpu")


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


def _check_ml_json(ours, ref):
    assert list(ours) == list(ref)
    for key, value in ref.items():
        if key in ("neg_log_likelihood", "ranking_score"):
            np.testing.assert_allclose(ours[key], value, rtol=2e-5)
        elif key == "mean_branch_length":
            np.testing.assert_allclose(ours[key], value, atol=1e-3)
        elif key == "tree":
            assert strip_lengths(ours[key]) == strip_lengths(value)
            np.testing.assert_allclose(lengths_of(ours[key]), lengths_of(value), atol=1e-3)
        else:
            assert ours[key] == value, key


@pytest.mark.parametrize("start", ["stepwise", "random"])
def test_infer_ml_ratchet_matches_jax(fasta, start):
    """``infer --criterion ml --ratchet 2``: the JSON the JAX CLI builds
    from its start tree and ``ml_iterated_search(PRNGKey(--seed + 13))``."""
    from trex_tpu.alignment import compress_alignment
    from trex_tpu.cli._common import _load_alignment, _start_tree
    from trex_tpu.io import save_newick

    flags = ["--criterion", "ml", "--neighborhood", "nni", "--rounds", "4", "--ratchet", "2",
             "--start", start]
    ours = _run(torch_cli, ["infer", "--alignment", fasta, "--device", "cpu", *flags])
    names, masks, _ = _load_alignment(fasta, "dna")
    patterns, weights = compress_alignment(masks)
    patterns = np.asarray(patterns, dtype=np.int32)
    weights = jnp.asarray(weights, jnp.float32)
    st = _start_tree(start, patterns, 4, 0, weights, 4)
    result, lengths, losses = jax_ml.ml_iterated_search(
        jax.random.PRNGKey(13), st, jnp.asarray(patterns), 4, n_iterations=2, max_rounds=4,
        neighborhood="nni", sequences_are_masks=True, site_weights=weights)
    ref = {
        "criterion": "ml", "start": start, "n_taxa": 10, "n_sites": 60,
        "unique_patterns": int((np.asarray(weights) > 0).sum()), "ml_iterations": 2,
        "neg_log_likelihood": float(losses[-1]), "ranking_score": result.score, "model": "jc",
        "mean_branch_length": float(np.asarray(lengths).mean()),
        "search_rounds": result.rounds, "evaluations": result.evaluations,
        "tree": save_newick(result.topology, names, np.asarray(lengths)),
    }
    _check_ml_json(ours, ref)


def test_infer_ml_constraint_matches_jax(fasta, tmp_path):
    clade = tmp_path / "clade.nwk"
    clade.write_text("((taxon_0,taxon_3),(taxon_5,taxon_7));\n")
    flags = ["--criterion", "ml", "--neighborhood", "nni", "--rounds", "6",
             "--constraint", str(clade)]
    ours = _run(torch_cli, ["infer", "--alignment", fasta, "--device", "cpu", *flags])
    ref = _run(jax_cli, ["infer", "--alignment", fasta, "--mesh", "1,1", *flags])
    assert ours["constraint_splits"] == 2 and ours["search_rounds"] > 0
    _check_ml_json(ours, ref)
