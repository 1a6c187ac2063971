"""End to end: ``trex_tpu_torch.cli infer --criterion ml --model ...
--device cpu`` against ``trex_tpu.cli infer ... --mesh 1,1`` on the same
FASTA: the model fit and one model <-> tree round (GTR+G, the scan ranking
under the fitted +G mixture). ``test_torch_ml_model_file_cli.py`` holds
``--model-file`` and the jc bases.

Both packages' ``optimize_model`` run 30 Adam steps instead of the CLI's
800, and a refit of the same tree returns the first fit (monkeypatched
alike), so the JAX oracle fits the suite's time. Same
keys in the same order, the same topology, ``search_rounds`` and
``model_rounds``; the final NLL within rtol 1e-4, the fitted parameters
(rounded as printed) within rtol 1e-2, branch lengths within atol 1e-3.
"""

import contextlib
import functools
import io
import json
import re

import numpy as np
import pytest
from _torch_parity import tree_fasta

import trex_tpu.cli as jax_cli
import trex_tpu.ops.likelihood as jl
import trex_tpu_torch.cli as torch_cli
import trex_tpu_torch.ops.likelihood as tl

_LENGTH = re.compile(r":([0-9.eE+-]+)")
FIT_STEPS = 30


def _run(cli, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    return json.loads(buf.getvalue())


def paml_file(path, q: int, seed: int) -> str:
    """A synthetic PAML rate file (lower triangle, then frequencies)."""
    rng = np.random.default_rng(seed)
    values = rng.uniform(0.1, 4.0, q * (q - 1) // 2)
    rows, k = [], 0
    for i in range(1, q):
        rows.append(" ".join(f"{v:.5f}" for v in values[k:k + i]))
        k += i
    freqs = rng.dirichlet(np.full(q, 4.0))
    path.write_text("\n".join(rows) + "\n" + " ".join(f"{f:.5f}" for f in freqs) + "\n")
    return str(path)


@pytest.fixture(scope="module")
def fasta(tmp_path_factory):
    path = tmp_path_factory.mktemp("aln") / "aln.fasta"
    path.write_text(tree_fasta(np.random.default_rng(9), 8, 60, 0.45))
    return str(path)


def _short_fit(fit):
    """``fit`` at FIT_STEPS steps, each topology's result kept: the
    command's inputs are otherwise the same in every call, so a model
    round that keeps the topology gets the same fit back without the JAX
    package compiling it again."""
    done = {}

    @functools.wraps(fit)
    def wrapped(topology, *args, **kwargs):
        children = topology.children
        key = np.asarray(children.cpu() if hasattr(children, "cpu") else children).tobytes()
        if key not in done:
            done[key] = fit(topology, *args, n_iterations=FIT_STEPS, **kwargs)
        return done[key]

    return wrapped


@pytest.fixture
def short_fits(monkeypatch):
    for module in (jl, tl):
        monkeypatch.setattr(module, "optimize_model", _short_fit(module.optimize_model))


def assert_same_ml_json(ours, ref):
    assert list(ours) == list(ref)
    for key, value in ref.items():
        if key == "tree":
            assert _LENGTH.sub("", ours[key]) == _LENGTH.sub("", value)
            np.testing.assert_allclose(
                [float(x) for x in _LENGTH.findall(ours[key])],
                [float(x) for x in _LENGTH.findall(value)], atol=1e-3)
        elif key in ("neg_log_likelihood", "ranking_score"):
            np.testing.assert_allclose(ours[key], value, rtol=1e-4, err_msg=key)
        elif isinstance(value, (float, list)) and value is not None:
            np.testing.assert_allclose(np.asarray(ours[key], dtype=float),
                                       np.asarray(value, dtype=float),
                                       rtol=1e-2, atol=1e-4, err_msg=key)
        else:
            assert ours[key] == value, key


def test_infer_model_rounds_match_jax(fasta, short_fits):
    argv = ["infer", "--alignment", fasta, "--start", "random", "--criterion", "ml",
            "--model", "gtr+g", "--model-rounds", "1"]
    ours = _run(torch_cli, argv + ["--device", "cpu"])
    ref = _run(jax_cli, argv + ["--mesh", "1,1"])
    assert_same_ml_json(ours, ref)
    assert ours["model_rounds"] == 1 and len(ours["gtr_rates"]) == 4
    assert ours["gamma_shape"] > 0
