"""End to end: ``infer --criterion ml --model empirical+g --model-file F``
of ``trex_tpu_torch.cli`` (``--device cpu``) against ``trex_tpu.cli ...
--mesh 1,1``, the exchangeabilities read from a synthetic PAML file made
from a seed, with both packages' ``optimize_model`` at 30 Adam steps; and
a jc base with a rate mixture, where the JAX command raises ``KeyError``
after its fit (its parameters have no "rates") and the port prints null
exchangeabilities (ROADMAP.md, accepted differences). Tolerances as ``test_torch_ml_models_cli.py``.
"""

import numpy as np
from test_torch_ml_models_cli import _run, assert_same_ml_json, fasta, paml_file, short_fits

import trex_tpu.cli as jax_cli
import trex_tpu.ops.likelihood as jl
import trex_tpu_torch.cli as torch_cli

__all__ = ["fasta", "short_fits"]  # fixtures shared with the GTR+G file


def test_infer_model_file_matches_jax(fasta, tmp_path, short_fits):
    argv = ["infer", "--alignment", fasta, "--criterion", "ml", "--model", "empirical+g",
            "--model-file", paml_file(tmp_path / "synthetic.dat", 4, 3)]
    ours = _run(torch_cli, argv + ["--device", "cpu"])
    ref = _run(jax_cli, argv + ["--mesh", "1,1"])
    assert_same_ml_json(ours, ref)
    assert ours["gtr_rates"] is None and "model_rounds" not in ours
    assert abs(sum(ours["base_frequencies"]) - 1.0) < 1e-4


def test_infer_jc_mixture(fasta, short_fits):
    argv = ["infer", "--alignment", fasta, "--criterion", "ml", "--model", "jc+r3",
            "--model-rounds", "1"]
    ours = _run(torch_cli, argv + ["--device", "cpu"])
    # The JAX command reads params["rates"] after the fit, which a jc base
    # does not build: it raises KeyError there.
    spec = jl._parse_model_string("jc+r3")
    assert "rates" not in jl._build_model_params(spec, jl._init_model_params(spec, 4), 4)[0]
    assert ours["gtr_rates"] is None and "model_rounds" not in ours
    assert ours["base_frequencies"] == [0.25] * 4
    weights = np.asarray(ours["category_weights"])
    assert weights.shape == (3,) and abs(weights.sum() - 1.0) < 1e-3
    assert np.isfinite(ours["neg_log_likelihood"]) and ours["mean_branch_length"] > 0
