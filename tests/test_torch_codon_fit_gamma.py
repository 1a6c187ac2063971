"""``models.codon.optimize_gy94`` against the JAX package's at 30 Adam
steps under GY94+G (GY94 alone: ``test_torch_codon_fit.py``), within the
fit tolerances of the port's model fits (ROADMAP §C: torch's
``matrix_exp`` against JAX's ``expm`` and Adam's bias corrections):
losses rtol 1e-5 over the first 20 steps and 1e-4 at the end, parameters
1e-2. 3 taxa x 16 codons simulated under GY94."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import parents_of, random_children

import trex_tpu.models.codon as jcd
from trex_tpu.topology import Topology as JaxTopology
from trex_tpu_torch.models import codon as cd
from trex_tpu_torch.topology import from_numpy


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(8)
    children = random_children(rng, 3, 1)[0]
    blens = rng.uniform(0.1, 0.5, 5).astype(np.float32)
    jtopo = JaxTopology(jnp.asarray(children), jnp.asarray(parents_of(children)))
    codons = jcd.simulate_gy94(jax.random.PRNGKey(1), jtopo, blens, kappa=2.5, omega=0.4,
                               n_sites=16)
    freqs = cd.empirical_codon_frequencies(codons)
    return from_numpy(children, parents_of(children)), jtopo, codons, freqs


def test_optimize_gy94_gamma_matches_jax(data):
    model = "gy94+g"
    topo, jtopo, codons, freqs = data
    params, losses = cd.optimize_gy94(topo, torch.as_tensor(codons), freqs=freqs, model=model,
                                      n_iterations=30)
    ref, ref_losses = jcd.optimize_gy94(jtopo, jnp.asarray(codons), freqs=freqs, model=model,
                                        n_iterations=30)
    np.testing.assert_allclose(losses[:20].numpy(), np.asarray(ref_losses)[:20], rtol=1e-5)
    np.testing.assert_allclose(losses.numpy(), np.asarray(ref_losses), rtol=1e-4)
    assert sorted(params) == sorted(ref)
    for key in params:
        np.testing.assert_allclose(params[key].numpy(), np.asarray(ref[key]), rtol=1e-2,
                                   atol=1e-2, err_msg=key)
