"""The port's ``simulate`` command on the CPU against the JAX CLI: it draws
the same tree, lengths, names and GTR model from ``--seed`` (the newick
equal), and, given the walk seed that the JAX command derives from its
key, the same FASTA and ancestors (a random tree under GTR+G+I, a serial
coalescent); a topology-only tree file; and ``dnds --model gy94+g
--search`` (the port alone: the GY94 SPR-scan climb at Q = 61 and the
refit). ``dnds`` against the JAX CLI: ``test_torch_dnds_cli.py``,
``test_torch_dnds_tree_cli.py``."""

import contextlib
import io
import json

import jax
import numpy as np
import pytest

import trex_tpu.cli as jax_cli
import trex_tpu_torch.cli as torch_cli
from trex_tpu_torch.cli import simulate as sim_cli


def _run(cli, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        cli.main(argv)
    return out.getvalue(), err.getvalue()


def _jax_walk_seed(monkeypatch, seed):
    """Make the port's command walk from the seed the JAX command derives."""
    derived = int(jax.random.randint(jax.random.key(seed), (), 0, 2**31 - 1))
    monkeypatch.setattr(sim_cli, "walk_seed", lambda s: derived)


@pytest.mark.parametrize("argv", [
    ["--leaves", "8", "--sites", "60", "--seed", "3", "--model", "gtr+g+i"],
    ["--leaves", "6", "--sites", "40", "--seed", "5", "--coalescent-ne", "0.5",
     "--sim-tip-ages", "0,0.2,0,0.4,0.1,0", "--clock-rate", "0.3"],
])
def test_simulate_equals_jax_cli(tmp_path, monkeypatch, argv):
    outs = {}
    for name, cli, extra in (("jax", jax_cli, []), ("port", torch_cli, ["--device", "cpu"])):
        paths = {k: str(tmp_path / f"{name}.{k}") for k in ("fasta", "nwk", "anc")}
        if name == "port":
            _jax_walk_seed(monkeypatch, int(argv[argv.index("--seed") + 1]))
        _, err = _run(cli, ["simulate", *argv, "--output", paths["fasta"], "--output-tree",
                            paths["nwk"], "--output-ancestors", paths["anc"], *extra])
        outs[name] = [json.loads(err.strip().splitlines()[-1])] + [
            open(paths[k]).read() for k in ("nwk", "fasta", "anc")]
    jax_out, port_out = outs["jax"], outs["port"]
    assert port_out[0] == {**jax_out[0], "output": port_out[0]["output"]}
    assert port_out[1:] == jax_out[1:]  # newick, FASTA and ancestors


def test_simulate_tree_file_and_own_walk_seed(tmp_path):
    tree = tmp_path / "topo.nwk"
    tree.write_text("((a,b),(c,(d,e)));\n")
    out, _ = _run(torch_cli, ["simulate", "--tree", str(tree), "--sites", "100",
                              "--default-blen", "0.2", "--device", "cpu"])
    names = [line[1:] for line in out.splitlines() if line.startswith(">")]
    rows = [line for line in out.splitlines() if not line.startswith(">")]
    assert names == ["a", "b", "c", "d", "e"] and {len(r) for r in rows} == {100}
    assert len(set(rows)) > 1  # the default lengths replaced the missing ones
    assert sim_cli.walk_seed(0) == int(np.random.default_rng([0, 1]).integers(0, 2**31 - 1))
    assert sim_cli.walk_seed(0) != sim_cli.walk_seed(1)


def test_dnds_search_runs_the_codon_climb(tmp_path):
    aln, tree = str(tmp_path / "codons.fasta"), str(tmp_path / "out.nwk")
    _run(torch_cli, ["simulate", "--model", "gy94", "--leaves", "5", "--sites", "40",
                     "--seed", "1", "--output", aln, "--device", "cpu"])
    out = json.loads(_run(torch_cli, ["dnds", "--alignment", aln, "--iterations", "20",
                                      "--model", "gy94+g", "--search", "--output-tree", tree,
                                      "--device", "cpu"])[0])
    assert out["tree_source"] == ("stepwise addition (nucleotide parsimony) + GY94 "
                                  "SPR-scan search")
    assert out["n_taxa"] == 5 and out["n_codons"] == 40 and out["output_tree"] == tree
    assert np.isfinite(out["log_likelihood"]) and out["kappa"] > 0 and out["omega"] > 0
    assert out["gamma_shape"] > 0
    assert open(tree).read().count(":") == 8
