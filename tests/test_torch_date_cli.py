"""``date`` and ``bayesfactor`` with ``--device cpu``: the JAX commands,
handed the port's fitted model, clock test and sampler results, print the
port's JSON, keys, order and values (the samplers themselves are held to
JAX's in ``test_torch_dating.py`` and ``test_torch_marginal.py``): ``date
--model gtr+g --clock relaxed --tree-prior coalescent --calibrate``,
``date --tip-ages`` and ``bayesfactor --models jc,gtr+g``. Fits cut to a
few Adam steps; 6 taxa x 200 sites."""

import contextlib
import functools
import io
import json

import numpy as np
import pytest
from _torch_parity import parents_of, random_children, tree_fasta

import trex_tpu.cli as jax_cli
import trex_tpu.ops.clock as jax_clock
import trex_tpu.ops.likelihood as jax_likelihood
import trex_tpu.search.dating as jax_dating
import trex_tpu.search.marginal as jax_marginal
import trex_tpu_torch.cli as torch_cli
import trex_tpu_torch.ops.clock as torch_clock
import trex_tpu_torch.ops.likelihood as torch_likelihood
import trex_tpu_torch.search.dating as torch_dating
import trex_tpu_torch.search.marginal as torch_marginal

N_TAXA = 6


def _json(cli, argv) -> dict:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    return json.loads(buf.getvalue())


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    from trex_tpu_torch.io import save_newick
    from trex_tpu_torch.topology import from_numpy

    root = tmp_path_factory.mktemp("date_cli")
    rng = np.random.default_rng(5)
    fasta = root / "aln.fasta"
    fasta.write_text(tree_fasta(rng, N_TAXA, 200, 0.08))
    children = random_children(rng, N_TAXA, 1)[0]
    names = [f"taxon_{i}" for i in range(N_TAXA)]
    tree = root / "tree.nwk"
    tree.write_text(save_newick(from_numpy(children, parents_of(children)), names[::-1]) + "\n")
    # The first ancestor joins two leaves: a clade to calibrate.
    cherry = ",".join(names[::-1][int(c)] for c in children[0])
    return dict(fasta=str(fasta), tree=str(tree), cherry=cherry)


def spy(monkeypatch, module, name, seen, **fixed):
    fn = getattr(module, name)
    if fixed:
        fn = functools.partial(fn, **fixed)

    def call(*args, **kwargs):
        out = fn(*args, **kwargs)
        seen.setdefault(name, []).append(out)
        return out

    monkeypatch.setattr(module, name, call)


def replay(monkeypatch, module, name, outputs):
    queue = list(outputs)
    monkeypatch.setattr(module, name, lambda *a, **k: queue.pop(0))


def fitted(params):
    return ({k: (v.numpy() if hasattr(v, "numpy") else v) for k, v in params.items()}, None)


@pytest.mark.parametrize("flags", [
    ["--model", "gtr+g", "--clock", "relaxed", "--tree-prior", "coalescent",
     "--calibrate", "CHERRY:0.01:2.0", "--calibrate", "root:0.05:3.0"],
    ["--tip-ages", ",".join(f"taxon_{i}={0.01 * i}" for i in range(N_TAXA))],
])
def test_date_json_equals_jax_on_one_result(files, monkeypatch, flags):
    seen: dict = {}
    spy(monkeypatch, torch_likelihood, "optimize_model", seen, n_iterations=3)
    spy(monkeypatch, torch_clock, "clock_lrt", seen, n_iterations=10)
    spy(monkeypatch, torch_dating, "mcmc_date", seen, clock_fit_iterations=10)
    argv = ["date", "--fasta", files["fasta"], "--tree", files["tree"], "--generations", "40",
            *(f.replace("CHERRY", files["cherry"]) for f in flags)]
    ours = _json(torch_cli, argv + ["--device", "cpu"])
    replay(monkeypatch, jax_likelihood, "optimize_model",
           [fitted(fit[0]) for fit in seen.get("optimize_model", [])])
    replay(monkeypatch, jax_clock, "clock_lrt", seen["clock_lrt"])
    replay(monkeypatch, jax_dating, "mcmc_date", seen["mcmc_date"])
    theirs = _json(jax_cli, argv)
    assert ours == theirs
    assert list(ours) == list(theirs)
    assert ours["clock_lrt"]["df"] == N_TAXA - 2
    assert len(ours["node_ages"]) == N_TAXA - 1
    assert ("coalescent_ne" in ours) == ("--tree-prior" in flags)
    assert ours.get("time_units") == "calibrated (absolute)"


def test_bayesfactor_json_equals_jax_on_one_result(files, monkeypatch):
    seen: dict = {}
    spy(monkeypatch, torch_likelihood, "optimize_model", seen, n_iterations=3)
    spy(monkeypatch, torch_marginal, "stepping_stone", seen)
    argv = ["bayesfactor", "--fasta", files["fasta"], "--tree", files["tree"], "--models",
            "jc,gtr+g", "--rungs", "4", "--generations", "10", "--seed", "2"]
    ours = _json(torch_cli, argv + ["--device", "cpu"])
    replay(monkeypatch, jax_likelihood, "optimize_model",
           [fitted(fit[0]) for fit in seen["optimize_model"]])
    replay(monkeypatch, jax_marginal, "stepping_stone", seen["stepping_stone"])
    theirs = _json(jax_cli, argv + ["--mesh", "1,1"])
    assert ours == theirs
    assert list(ours) == list(theirs)
    assert list(ours["models"]) == ["jc", "gtr+g"]
    assert "gamma_shape" in ours["models"]["gtr+g"]
    assert ours["rungs"] == 4 and ours["n_taxa"] == N_TAXA


def test_samplers_report_their_timings(files):
    """``run_date``, ``run_bayesfactor`` and ``run_mcmc`` put their parts'
    wall seconds in ``timings``; ``clock_iterations`` sets the Adam steps
    of both clock fits."""
    from trex_tpu_torch.cli import build_parser
    from trex_tpu_torch.cli.bayes import run_bayesfactor, run_date, run_mcmc

    def args(*argv):
        return build_parser().parse_args([*argv, "--device", "cpu"])

    seen: dict = {}
    run_date(args("date", "--fasta", files["fasta"], "--tree", files["tree"],
                  "--generations", "10"), seen, clock_iterations=5)
    assert sorted(seen) == ["clock_lrt", "sampler", "start_fit"]
    seen = {}
    run_bayesfactor(args("bayesfactor", "--fasta", files["fasta"], "--tree", files["tree"],
                         "--models", "jc,gtr", "--rungs", "4", "--generations", "5"), seen)
    assert sorted(seen) == ["gtr", "jc"] and all(list(v) == ["sampler"] for v in seen.values())
    more: dict = {}
    run_mcmc(args("mcmc", "--fasta", files["fasta"], "--generations", "10"), more)
    assert list(more) == ["sampler"]
    assert all(t > 0 for t in [seen["jc"]["sampler"], seen["gtr"]["sampler"], more["sampler"]])
