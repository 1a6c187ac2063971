"""End to end: ``score --criterion ml`` of ``trex_tpu_torch.cli``
(``--device cpu``) against ``trex_tpu.cli`` on the same files.

``score --criterion ml --model hky+g --asr joint --site-rates F
--output-fasta A`` on a given tree: both packages' ``optimize_model`` run
30 Adam steps instead of 800 (monkeypatched alike); the same keys in the
same order, likelihoods within rtol 1e-4, the site rates and the
reconstructed FASTA agreeing at all but near-tied sites. JC69 without
``--model`` (the Adam length fit, also cut to 30 steps) likewise. The JAX
command's unjitted likelihood and site-rate calls run jitted, to fit the
suite's time. ``--site-rates`` without a mixture is refused.
"""

import contextlib
import functools
import io
import json
import re

import jax
import numpy as np
import pytest
import torch
from _torch_parity import parents_of, random_children, tree_fasta

import trex_tpu.cli as jax_cli
import trex_tpu.ops.likelihood as jl
import trex_tpu_torch.cli as torch_cli
import trex_tpu_torch.ops.likelihood as tl
from trex_tpu_torch.io import save_newick
from trex_tpu_torch.topology import Topology


def _run(cli, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    return json.loads(buf.getvalue())


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("score")
    rng = np.random.default_rng(14)
    n = 9
    (root / "aln.fasta").write_text(tree_fasta(rng, n, 50, 0.4))
    children = random_children(rng, n, 1)[0]
    topo = Topology(torch.as_tensor(children), torch.as_tensor(parents_of(children)))
    names = [f"taxon_{i}" for i in range(n)]
    lengths = rng.uniform(0.05, 0.8, 2 * n - 1)
    (root / "tree.nwk").write_text(save_newick(topo, names) + "\n")
    (root / "lengths.nwk").write_text(save_newick(topo, names, lengths) + "\n")
    # A trait that follows the tree: one state per side of the root, one
    # leaf with a third state, one missing.
    side = {children[-1][0]: "fin", children[-1][1]: "wing"}
    for a in range(n - 2, -1, -1):
        for c in children[a]:
            side.setdefault(int(c), side.get(n + a))
    traits = np.array([side[i] for i in range(n)], dtype=object)
    traits[int(np.argmax(traits == "wing"))] = "leg"
    traits[int(np.argmax(traits == "fin"))] = "?"
    (root / "traits.tsv").write_text(
        "# taxon\tstate\n" + "".join(f"{a},{b}\n" for a, b in zip(names, traits)))
    return root


@pytest.fixture
def short_fits(monkeypatch):
    """30-step fits (model and lengths) in both packages; the JAX command's
    likelihood and site rates jitted (the same functions, compiled whole instead of op by op)."""
    for module in (jl, tl):
        for name in ("optimize_model", "optimize_branch_lengths"):
            monkeypatch.setattr(module, name, functools.partial(
                getattr(module, name), n_iterations=30))
    monkeypatch.setattr(jl, "tree_log_likelihood", jax.jit(
        jl.tree_log_likelihood, static_argnums=(3,), static_argnames=("sequences_are_masks",)))
    monkeypatch.setattr(jl, "posterior_site_rates", jax.jit(
        jl.posterior_site_rates, static_argnums=(3, 5),
        static_argnames=("sequences_are_masks",)))


def _fasta_rows(path):
    lines = path.read_text().split("\n")
    return np.array([list(r) for r in lines[1::2] if r])


@pytest.mark.parametrize("model", ["hky+g", "jc"])
def test_score_ml_matches_jax(files, model, short_fits, tmp_path):
    outs = {}
    for name, cli, extra in (("ours", torch_cli, ["--device", "cpu"]), ("ref", jax_cli, [])):
        argv = ["score", "--alignment", str(files / "aln.fasta"), "--tree",
                str(files / "tree.nwk"), "--criterion", "ml", "--model", model,
                "--asr", "joint" if model != "jc" else "marginal",
                "--output-fasta", str(tmp_path / f"{name}.fasta")]
        if model != "jc":
            argv += ["--site-rates", str(tmp_path / f"{name}.rates")]
        outs[name] = _run(cli, argv + extra)
    ours, ref = outs["ours"], outs["ref"]
    assert list(ours) == list(ref)
    for key, value in ref.items():
        if isinstance(value, float):
            np.testing.assert_allclose(ours[key], value, rtol=1e-4, err_msg=key)
        elif key not in ("output_fasta", "site_rates"):
            assert ours[key] == value, key
    rows_t, rows_j = _fasta_rows(tmp_path / "ours.fasta"), _fasta_rows(tmp_path / "ref.fasta")
    assert (rows_t == rows_j).all(axis=0).mean() >= 0.9
    if model != "jc":
        rates_t = np.loadtxt(tmp_path / "ours.rates", skiprows=1)
        rates_j = np.loadtxt(tmp_path / "ref.rates", skiprows=1)
        np.testing.assert_allclose(rates_t, rates_j, rtol=1e-3, atol=2e-6)


@pytest.mark.parametrize("model", ["jc", "hky"])
def test_site_rates_need_a_mixture(files, model, tmp_path, short_fits):
    """The JAX command's message, for JC69 and for a model without one."""
    with pytest.raises(SystemExit, match="needs a rate-mixture model"):
        _run(torch_cli, ["score", "--alignment", str(files / "aln.fasta"), "--tree",
                         str(files / "tree.nwk"), "--criterion", "ml", "--model", model,
                         "--site-rates", str(tmp_path / "r.tsv"), "--device", "cpu"])
