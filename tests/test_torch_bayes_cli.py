"""``python -m trex_tpu_torch.cli mcmc --device cpu`` against ``python -m
trex_tpu.cli mcmc`` on a 6-taxon alignment with a clear signal: the JAX
command's keys in its order, the deterministic fields equal, and (each on
its own draws) the same consensus tree and top splits; the port's
``--output-tree``, ``--samples-out`` and ``--trace-out`` written as the
JAX command writes them; under ``--full-bayes`` the JAX command, handed
the port's fit and sampler result, prints the port's JSON. In one process
``--mesh 2,1`` asks for more devices than the process has, ``--mesh 1,1``
and ``--mesh auto`` run on the one device; ``date``, whose JAX command has
no ``--mesh``, refuses a launcher's world of two ranks
(``test_torch_bayes_mesh_cli.py``: ``mcmc`` and ``bayesfactor`` on two
ranks); without ``--device`` the commands ask for the card (none here).
200 generations."""

import contextlib
import io
import json
import re

import numpy as np
import pytest
from _torch_parity import tree_fasta

import trex_tpu.cli as jax_cli
import trex_tpu_torch.cli as torch_cli

DETERMINISTIC = ("n_taxa", "n_sites", "unique_patterns", "generations", "runs", "chains",
                 "proposal", "model", "n_samples")


def _json(cli, argv) -> dict:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    return json.loads(buf.getvalue())


@pytest.fixture(scope="module")
def fasta(tmp_path_factory):
    path = tmp_path_factory.mktemp("bayes_cli") / "aln.fasta"
    path.write_text(tree_fasta(np.random.default_rng(2), 6, 300, 0.08))
    return str(path)


def test_mcmc_cli_equals_jax(fasta, tmp_path):
    argv = ["mcmc", "--fasta", fasta, "--generations", "200", "--seed", "3"]
    outs = {name: str(tmp_path / name) for name in ("tree", "samples", "trace")}
    ours = _json(torch_cli, argv + ["--device", "cpu", "--output-tree", outs["tree"],
                                    "--samples-out", outs["samples"], "--trace-out",
                                    outs["trace"]])
    theirs = _json(jax_cli, argv + ["--mesh", "1,1"])
    assert list(ours) == list(theirs)
    for key in DETERMINISTIC:
        assert ours[key] == theirs[key], key
    assert list(ours["acceptance"]) == list(theirs["acceptance"])
    assert ours["consensus_tree"] == theirs["consensus_tree"]
    assert [s["clade"] for s in ours["top_splits"]] == [s["clade"] for s in theirs["top_splits"]]
    assert all(s["posterior"] == 1.0 for s in ours["top_splits"] + theirs["top_splits"])
    assert ours["mean_lnl"] == pytest.approx(theirs["mean_lnl"], rel=2e-3)
    assert open(outs["tree"]).read() == ours["consensus_tree"] + "\n"
    samples = open(outs["samples"]).read().splitlines()
    assert len(samples) == ours["n_samples"]
    assert all(re.fullmatch(r"\(.*\);", s) and "taxon_0:" in s for s in samples)
    trace = open(outs["trace"]).read().splitlines()
    assert trace[0].split("\t") == ["state", "lnL", "tree_length"]
    assert len(trace) == ours["n_samples"] + 1


def test_full_bayes_json_equals_jax_on_one_result(fasta, monkeypatch):
    """``--full-bayes`` (the ML fit seeding the chains: 3 Adam steps here):
    the JAX command, handed the port's fitted model and sampler result,
    prints the port's JSON, keys and values."""
    import functools

    import trex_tpu.ops.likelihood as jax_likelihood
    import trex_tpu.search.mcmc as jax_mcmc
    import trex_tpu.search.nj as jax_nj
    import trex_tpu_torch.ops.likelihood as torch_likelihood
    import trex_tpu_torch.search.mcmc as torch_mcmc

    seen = {}

    def spy(name, fn):
        def call(*args, **kwargs):
            seen[name] = fn(*args, **kwargs)
            return seen[name]
        return call

    monkeypatch.setattr(torch_likelihood, "optimize_model", spy("fit", functools.partial(
        torch_likelihood.optimize_model, n_iterations=3)))
    monkeypatch.setattr(torch_mcmc, "mcmc_sample", spy("res", torch_mcmc.mcmc_sample))
    argv = ["mcmc", "--fasta", fasta, "--generations", "20", "--sample-every", "10",
            "--full-bayes", "--proposal", "nni", "--runs", "1", "--chains", "2"]
    ours = _json(torch_cli, argv + ["--device", "cpu"])
    params = {k: v.numpy() for k, v in seen["fit"][0].items() if k in ("rates", "freqs")}
    monkeypatch.setattr(jax_nj, "nj_start_tree", lambda *a, **k: (None, None))
    monkeypatch.setattr(jax_likelihood, "optimize_model", lambda *a, **k: (params, None))
    monkeypatch.setattr(jax_mcmc, "mcmc_sample", lambda *a, **k: seen["res"])
    theirs = _json(jax_cli, argv + ["--mesh", "1,1"])
    assert ours == theirs
    assert list(ours) == list(theirs)
    assert ours["model"] == "gtr (full Bayes)"
    assert len(ours["posterior_freqs"]) == 4 and len(ours["posterior_rates"]) == 6


@pytest.mark.parametrize("command", ["mcmc", "bayesfactor"])
def test_mesh_needs_the_ranks_it_names(fasta, tmp_path, command):
    """``--mesh 2,1`` in one process: the JAX CLI's refusal, before the
    sampler runs."""
    argv = [command, "--fasta", fasta, "--mesh", "2,1", "--device", "cpu"]
    if command == "bayesfactor":
        argv += ["--tree", str(tmp_path / "none.nwk")]
    with pytest.raises(SystemExit, match=r"--mesh 2,1: 2\*1 != 1 addressable devices"):
        torch_cli.main(argv)


@pytest.mark.parametrize("spec", ["1,1", "auto"])
def test_one_process_mesh_is_one_device(fasta, spec):
    argv = ["mcmc", "--fasta", fasta, "--generations", "20", "--sample-every", "10",
            "--runs", "1", "--chains", "2", "--device", "cpu"]
    assert _json(torch_cli, argv + ["--mesh", spec]) == _json(torch_cli, argv)


@pytest.mark.parametrize("command", ["date"])
def test_launched_world_is_refused(fasta, tmp_path, monkeypatch, command):
    """A launcher's two-rank world (``torchrun``'s environment) is refused
    before any rank runs a command whose JAX counterpart has no ``--mesh``."""
    for name, value in (("RANK", "0"), ("WORLD_SIZE", "2"), ("LOCAL_RANK", "0"),
                        ("MASTER_ADDR", "localhost"), ("MASTER_PORT", "1")):
        monkeypatch.setenv(name, value)
    argv = [command, "--fasta", fasta, "--tree", str(tmp_path / "none.nwk"), "--device", "cpu"]
    with pytest.raises(SystemExit, match=f"the JAX CLI's {command} has no --mesh"):
        torch_cli.main(argv)


@pytest.mark.parametrize("command", ["mcmc", "date", "bayesfactor"])
def test_default_device_is_the_card(fasta, tmp_path, command):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    argv = [command, "--fasta", fasta]
    if command != "mcmc":
        argv += ["--tree", str(tmp_path / "none.nwk")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_cli.main(argv)
