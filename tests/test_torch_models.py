"""The model layer of ``trex_tpu_torch/ops/likelihood.py`` against
``trex_tpu/ops/likelihood.py``: the model grammar, parameters built from the
same unconstrained values, ``discrete_gamma_rates`` and
``io.parse_paml_rates`` (``test_torch_mixtures.py`` holds the mixture
likelihoods). Inputs are made with numpy from a seed and handed to both
packages; built parameters within 1e-6, the Gamma rates within 2e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import trex_tpu.io as jax_io
import trex_tpu.ops.likelihood as jl
import trex_tpu_torch.io as torch_io
import trex_tpu_torch.ops.likelihood as tl

MODELS = ["jc", "k80", "hky", "f81", "tn93", "gtr", "empirical",
          "gtr+g", "gtr+i", "gtr+g+i", "hky+r2", "jc+r8", "empirical+g", "TN93+G"]
# One model of each parameter kind for the numeric checks.
BUILT = ["k80+g", "hky+i", "f81", "tn93+g+i", "gtr+r3", "empirical", "jc+r8"]


@pytest.mark.parametrize("model", MODELS)
def test_model_grammar_matches(model):
    assert tl._parse_model_string(model) == jl._parse_model_string(model)


@pytest.mark.parametrize("model", ["lg", "gtr+r1", "gtr+r9", "gtr+i+g", "gtr+g+r3", "jc+"])
def test_model_grammar_refuses(model):
    with pytest.raises(ValueError, match="unknown model"):
        jl._parse_model_string(model)
    with pytest.raises(ValueError, match="unknown model"):
        tl._parse_model_string(model)


@pytest.mark.parametrize("model", ["k80", "hky+g", "f81", "tn93+i"])
def test_nucleotide_models_need_four_states(model):
    spec = tl._parse_model_string(model)
    with pytest.raises(ValueError, match="nucleotide model"):
        jl._init_model_params(jl._parse_model_string(model), 20)
    with pytest.raises(ValueError, match="nucleotide model"):
        tl._init_model_params(spec, 20)


@pytest.mark.parametrize("model", BUILT)
def test_built_parameters_match(model):
    """The same unconstrained values (the initial ones, moved by a seeded
    offset) build the same constrained parameters."""
    q = 20 if model.startswith("empirical") else 4
    rng = np.random.default_rng(len(model))
    fixed_rates = rng.uniform(0.1, 2.0, (q, q)).astype(np.float32)
    fixed_rates = (fixed_rates + fixed_rates.T) / 2
    spec_j = jl._parse_model_string(model)
    spec_t = tl._parse_model_string(model)
    init_j = jl._init_model_params(spec_j, q)
    init_t = tl._init_model_params(spec_t, q)
    assert sorted(init_j) == sorted(init_t)
    moved = {}
    for key, value in init_j.items():
        value = np.asarray(value)
        np.testing.assert_allclose(init_t[key].numpy(), value, rtol=1e-6, atol=1e-7)
        moved[key] = (value + rng.normal(0, 0.5, value.shape)).astype(np.float32)
    built_j, rates_j, freqs_j = jl._build_model_params(
        spec_j, {k: jnp.asarray(v) for k, v in moved.items()}, q, jnp.asarray(fixed_rates))
    built_t, rates_t, freqs_t = tl._build_model_params(
        spec_t, tl.model_params_from_numpy(spec_t, moved), q, torch.as_tensor(fixed_rates))
    assert list(built_t) == list(built_j)
    for key in built_j:
        np.testing.assert_allclose(built_t[key].numpy(), np.asarray(built_j[key]),
                                   rtol=1e-6, atol=1e-7, err_msg=key)
    assert (rates_t is None) == (rates_j is None) and (freqs_t is None) == (freqs_j is None)


def test_model_params_from_numpy_refuses_foreign_keys():
    with pytest.raises(ValueError, match="do not belong"):
        tl.model_params_from_numpy("hky", {"gamma_shape": np.float32(1.0)})


@pytest.mark.parametrize("shape", [0.05, 0.3, 1.0, 2.7, 40.0])
@pytest.mark.parametrize("k", [1, 4, 7])
def test_discrete_gamma_rates(shape, k):
    want = jax.jit(jl.discrete_gamma_rates, static_argnums=1)(np.float32(shape), k)
    # rtol 2e-5, as the mixtures: at shape 0.05 the lowest rate is a cube
    # of a near-cancellation, and jitted JAX differs from op-by-op JAX by
    # 2.7e-6 there.
    np.testing.assert_allclose(tl.discrete_gamma_rates(shape, k).numpy(), np.asarray(want),
                               rtol=2e-5)


def _paml_text(rng, q: int) -> str:
    values = rng.uniform(0.01, 5.0, q * (q - 1) // 2)
    freqs = rng.dirichlet(np.ones(q)) * 3.0  # not normalised in the file
    rows, k = [], 0
    for i in range(1, q):
        rows.append(" ".join(f"{v:.6f}" for v in values[k:k + i]))
        k += i
    return ("# a synthetic matrix\n" + "\n".join(rows) + "\n\n"
            + " ".join(f"{f:.6f}" for f in freqs) + "\n// trailing citation text\nLG et al.\n")


@pytest.mark.parametrize("q", [4, 20])
def test_parse_paml_rates(q):
    text = _paml_text(np.random.default_rng(q), q)
    rates, freqs = torch_io.parse_paml_rates(text, q)
    want_rates, want_freqs = jax_io.parse_paml_rates(text, q)
    assert rates.dtype == np.float32 and freqs.dtype == np.float32
    np.testing.assert_array_equal(rates, want_rates)
    np.testing.assert_array_equal(freqs, want_freqs)
    short = text.split("\n\n")[0]
    for module in (torch_io, jax_io):
        with pytest.raises(ValueError, match="numbers"):
            module.parse_paml_rates(short, q)
        with pytest.raises(ValueError, match="unexpected token"):
            module.parse_paml_rates("0.5 x 0.2", q)
