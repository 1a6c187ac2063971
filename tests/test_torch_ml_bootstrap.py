"""The ML bootstrap on the CPU against the JAX package:
``ml_bootstrap_analysis`` (the same supports and replicate trees under
JAX's replicate weights, its candidates ranked through K3/K4's per-branch
mode), ``bootstrap_log_likelihoods``, the K3/K4 wrapper's launch counts by
mode, and ``infer --criterion ml --start nj --bootstrap`` against the JAX
CLI's run without ``--bootstrap`` plus JAX's ``ml_bootstrap_analysis``
under the CLI's key (the JAX CLI's own bootstrap takes minutes).

The candidates are ranked on the CPU by K4's plain version, JAX by lax
(about 1e-7 relative apart): the alignments are evolved at a rate whose
best candidates lie further apart than that.
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
    jax_replicate_draws,
    jitted_jax_scores,
    lengths_of,
    parents_of,
    random_children,
    strip_lengths,
    tree_fasta,
)

import trex_tpu.cli as jax_cli
import trex_tpu.ops.likelihood as jax_likelihood
import trex_tpu.search.bootstrap as jax_bootstrap
import trex_tpu.search.ml as jax_ml
import trex_tpu_torch.ops.likelihood_cuda as likelihood_cuda
import trex_tpu_torch.search.bootstrap as torch_bootstrap
from trex_tpu.topology import Topology as JaxTopology
from trex_tpu_torch.cli import build_parser
from trex_tpu_torch.cli.infer import run_infer
from trex_tpu_torch.topology import from_numpy


@pytest.fixture
def jitted_likelihood(monkeypatch):
    """The JAX package's candidate likelihoods jitted (the same function,
    compiled whole instead of op by op)."""
    fast = jax.jit(jax_likelihood.tree_log_likelihood, static_argnums=(3,),
                   static_argnames=("sequences_are_masks",))
    monkeypatch.setattr(jax_likelihood, "tree_log_likelihood", fast)
    monkeypatch.setattr(jax_ml, "tree_log_likelihood", fast)


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(7)
    masks = evolved_masks(rng, random_children(rng, 10, 1)[0], 60, 0.3)
    start = random_children(rng, 10, 1)[0]
    return masks, start, parents_of(start)


def test_ml_bootstrap_matches_jax(case, jitted_likelihood, monkeypatch):
    masks, children, parents = case
    key = jax.random.PRNGKey(11)
    ref_support, ref_best = jax_bootstrap.ml_bootstrap_analysis(
        key, JaxTopology(jnp.asarray(children), jnp.asarray(parents)), jnp.asarray(masks), 4,
        n_replicates=3, search_rounds=3, sequences_are_masks=True)
    draws = np.array(jax_bootstrap._replicate_weights(key, 60, 3, None))
    modes = []
    kernel = likelihood_cuda.batched_log_likelihood_cuda

    def recording(children, leaves, weights, prior, transition, **kw):
        modes.append(tuple(transition.shape))
        return kernel(children, leaves, weights, prior, transition, **kw)

    monkeypatch.setattr(likelihood_cuda, "batched_log_likelihood_cuda", recording)
    support, best = torch_bootstrap.ml_bootstrap_analysis(
        from_numpy(children, parents), torch.as_tensor(masks), 4, n_replicates=3,
        search_rounds=3, sequences_are_masks=True, replicate_weights=draws, device="cpu")
    np.testing.assert_array_equal(support, ref_support)
    assert 0.0 in support and 1.0 in support
    for ours, ref in zip(best, ref_best, strict=True):
        assert np.array_equal(ours.children.numpy(), np.asarray(ref.children))
    # Every batch ranked with a P per branch and tree (K4's mode).
    assert modes and all(len(m) == 4 and m[1:] == (19, 4, 4) for m in modes)


def test_bootstrap_log_likelihoods_match_jax(case):
    masks, children, parents = case
    rng = np.random.default_rng(2)
    states = np.log2(masks).astype(np.int32)
    lengths = rng.uniform(0.05, 0.3, 19).astype(np.float32)
    weights = rng.integers(0, 3, (4, 60)).astype(np.float32)
    ref = jax_bootstrap.bootstrap_log_likelihoods(
        JaxTopology(jnp.asarray(children), jnp.asarray(parents)), jnp.asarray(lengths),
        jnp.asarray(states), 4, jnp.asarray(weights))
    got = torch_bootstrap.bootstrap_log_likelihoods(
        from_numpy(children, parents), torch.as_tensor(lengths), torch.as_tensor(states), 4,
        weights)
    assert got.shape == (4,)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-6)


def test_likelihood_launches_counted_by_mode(case, monkeypatch):
    """A launching call adds its grids to the total, one to the calls and
    its grids to its mode's count; a CPU call runs the plain version and
    counts nothing."""
    fn = likelihood_cuda.batched_log_likelihood_cuda
    monkeypatch.setattr(fn, "launches", 0)
    monkeypatch.setattr(fn, "calls", 0)
    monkeypatch.setattr(fn, "launches_by_mode", {"shared": 0, "per_branch": 0})
    likelihood_cuda.count_launch(3, True)
    likelihood_cuda.count_launch(4, False)
    likelihood_cuda.count_launch(3, True)
    assert (fn.launches, fn.calls) == (10, 3)
    assert fn.launches_by_mode == {"shared": 6, "per_branch": 4}
    masks, children, _ = case
    p = jax_likelihood.jc69_transition(jnp.asarray(0.1), 4)
    for transition in (np.asarray(p), np.broadcast_to(np.asarray(p), (1, 19, 4, 4))):
        fn(torch.as_tensor(children[None]), torch.as_tensor(masks), torch.ones(60),
           torch.full((4,), 0.25), torch.as_tensor(np.array(transition)),
           sequences_are_masks=True)
    assert (fn.launches, fn.calls) == (10, 3)
    assert fn.launches_by_mode == {"shared": 6, "per_branch": 4}


def _run(cli, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    return json.loads(buf.getvalue())


def test_infer_ml_bootstrap_matches_jax(tmp_path, jitted_likelihood, monkeypatch):
    """``infer --criterion ml --start nj --bootstrap 2``: the JAX CLI's keys
    and order, tree, scores and lengths; supports equal to JAX's
    ``ml_bootstrap_analysis`` on that tree under the CLI's key
    ``PRNGKey(--seed + 1)``."""
    fasta = tmp_path / "aln.fasta"
    fasta.write_text(tree_fasta(np.random.default_rng(5), 10, 60, 0.5))
    jitted_jax_scores(monkeypatch)
    jax_replicate_draws(monkeypatch, 1)
    argv = ["infer", "--alignment", str(fasta), "--criterion", "ml", "--start", "nj",
            "--neighborhood", "nni", "--rounds", "4"]
    run = run_infer(build_parser().parse_args([*argv, "--device", "cpu", "--bootstrap", "2"]))
    ours = run.out
    ref = _run(jax_cli, [*argv, "--mesh", "1,1"])
    names = list(ref)
    at = names.index("mean_branch_length") + 1
    assert list(ours) == names[:at] + [
        "bootstrap_replicates", "mean_split_support", "split_support"] + names[at:]
    for key in ("criterion", "start", "n_taxa", "n_sites", "unique_patterns", "model",
                "search_rounds", "evaluations"):
        assert ours[key] == ref[key], key
    for key in ("neg_log_likelihood", "ranking_score"):
        np.testing.assert_allclose(ours[key], ref[key], rtol=2e-5)
    np.testing.assert_allclose(ours["mean_branch_length"], ref["mean_branch_length"], atol=1e-3)
    assert strip_lengths(ours["tree"]) == strip_lengths(ref["tree"])
    np.testing.assert_allclose(lengths_of(ours["tree"]), lengths_of(ref["tree"]), atol=1e-3)
    children, parents = run.result.topology.to_numpy()
    from trex_tpu.alignment import compress_alignment
    from trex_tpu.cli._common import _load_alignment

    _, masks, _ = _load_alignment(str(fasta), "dna")
    patterns, weights = compress_alignment(masks)
    support, _ = jax_bootstrap.ml_bootstrap_analysis(
        jax.random.PRNGKey(1), JaxTopology(jnp.asarray(children), jnp.asarray(parents)),
        jnp.asarray(patterns), 4, n_replicates=2, search_rounds=3,
        site_weights=jnp.asarray(weights, jnp.float32), sequences_are_masks=True)
    assert ours["bootstrap_replicates"] == 2
    assert ours["split_support"] == [round(float(s), 3) for s in support]
    assert ours["mean_split_support"] == pytest.approx(float(np.mean(support)))
    assert run.seconds["bootstrap"] > 0
