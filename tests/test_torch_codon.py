"""The port's codon models (``models/codon.py``) against the JAX package's:
the genetic-code tables and GY94's pair tables equal; exchangeabilities and
generators within 1e-6; ``encode_codons`` equal in both stop modes, its
error too; the F61, F3x4 and F1x4 estimators equal; the GY94 log-likelihood
(+G too) within rtol 2e-5; ``simulate_gy94`` equal given the numpy seed
that the JAX function derives from its key. 6 taxa x 30 codons. The fits:
``test_torch_codon_fit.py``."""

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

N_TAXA, N_CODONS_SIM = 6, 30


def _tree(seed):
    rng = np.random.default_rng(seed)
    children = random_children(rng, N_TAXA, 1)[0]
    blens = rng.uniform(0.05, 0.4, 2 * N_TAXA - 1).astype(np.float32)
    return (children, blens, from_numpy(children, parents_of(children)),
            JaxTopology(jnp.asarray(children), jnp.asarray(parents_of(children))))


def _jax_seed(key) -> int:
    return int(jax.random.randint(key, (), 0, 2**31 - 1))


@pytest.fixture(scope="module")
def alignment():
    """(nucleotide states (n, 3 L) with missing data, codon states, tree)."""
    children, blens, topo, jtopo = _tree(1)
    key = jax.random.PRNGKey(4)
    codons = jcd.simulate_gy94(key, jtopo, blens, kappa=2.5, omega=0.4, n_sites=N_CODONS_SIM)
    nuc = np.array([["ACGT".index(b) for b in "".join(cd.SENSE_CODONS[c] for c in row)]
                    for row in codons], np.int32)
    nuc[np.random.default_rng(2).random(nuc.shape) < 0.03] = -1
    return nuc, jcd.encode_codons(nuc), (children, blens, topo, jtopo), key


def test_tables_equal():
    assert cd.GENETIC_CODE == jcd.GENETIC_CODE
    assert cd.SENSE_CODONS == jcd.SENSE_CODONS and cd.N_CODONS == 61
    assert cd.CODON_INDEX == jcd.CODON_INDEX
    assert cd.STOP_CODONS == jcd.STOP_CODONS
    assert cd.CODON_AMINO_ACIDS == jcd.CODON_AMINO_ACIDS
    for ours, ref in zip(cd._pair_tables(), jcd._pair_tables(), strict=True):
        np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("kappa, omega", [(2.0, 0.5), (0.7, 3.1)])
def test_exchangeabilities_and_generator(kappa, omega):
    freqs = np.random.default_rng(3).dirichlet(np.full(61, 4.0)).astype(np.float32)
    np.testing.assert_allclose(cd.gy94_exchangeabilities(kappa, omega).numpy(),
                               np.asarray(jcd.gy94_exchangeabilities(kappa, omega)), atol=1e-6)
    np.testing.assert_allclose(
        cd.gy94_generator(kappa, omega, freqs).numpy(),
        np.asarray(jcd.gy94_generator(jnp.float32(kappa), jnp.float32(omega),
                                      jnp.asarray(freqs))), atol=1e-6)
    # Differentiable in kappa and omega.
    k = torch.tensor(kappa, requires_grad=True)
    w = torch.tensor(omega, requires_grad=True)
    cd.gy94_generator(k, w, freqs).sum().backward()
    assert k.grad is not None and w.grad is not None


def test_encode_codons_equal(alignment):
    nuc = alignment[0]
    np.testing.assert_array_equal(cd.encode_codons(nuc), jcd.encode_codons(nuc))
    with_stop = nuc.copy()
    with_stop[1, 6:9] = [3, 0, 0]  # TAA
    with pytest.raises(ValueError) as ours:
        cd.encode_codons(with_stop)
    with pytest.raises(ValueError) as ref:
        jcd.encode_codons(with_stop)
    assert str(ours.value) == str(ref.value)
    missing = cd.encode_codons(with_stop, stops="missing")
    np.testing.assert_array_equal(missing, jcd.encode_codons(with_stop, stops="missing"))
    assert missing[1, 2] == cd.MISSING
    with pytest.raises(ValueError, match="stops must be"):
        cd.encode_codons(nuc, stops="drop")


def test_frequency_estimators_equal(alignment):
    nuc, codons = alignment[:2]
    for mode in ("f61", "f3x4", "f1x4"):
        np.testing.assert_array_equal(
            cd.codon_frequencies(codons, mode=mode, nuc_states=nuc),
            jcd.codon_frequencies(codons, mode=mode, nuc_states=nuc))
    with pytest.raises(ValueError, match="need nuc_states"):
        cd.codon_frequencies(codons, mode="f3x4")


@pytest.mark.parametrize("gamma_shape", [None, 0.7])
def test_log_likelihood_matches_jax(alignment, gamma_shape):
    nuc, codons, (_, blens, topo, jtopo), _ = alignment
    freqs = cd.f3x4_frequencies(nuc)
    weights = np.random.default_rng(5).integers(1, 4, codons.shape[1]).astype(np.float32)
    ours = cd.gy94_log_likelihood(topo, torch.as_tensor(blens), codons, kappa=2.0, omega=0.6,
                                  freqs=freqs, gamma_shape=gamma_shape,
                                  site_weights=torch.as_tensor(weights))
    ref = jax.jit(lambda *a: jcd.gy94_log_likelihood(
        *a, kappa=2.0, omega=0.6, freqs=jnp.asarray(freqs), gamma_shape=gamma_shape,
        site_weights=jnp.asarray(weights)))(jtopo, jnp.asarray(blens), jnp.asarray(codons))
    np.testing.assert_allclose(float(ours), float(ref), rtol=2e-5)


def test_simulate_gy94_equal_under_the_jax_seed(alignment):
    _, codons, (_, blens, topo, _), key = alignment
    freqs = np.random.default_rng(6).dirichlet(np.full(61, 3.0))
    ours = cd.simulate_gy94(_jax_seed(key), topo, blens, kappa=2.5, omega=0.4,
                            n_sites=N_CODONS_SIM)
    np.testing.assert_array_equal(ours, jcd.encode_codons(np.array(
        [["ACGT".index(b) for b in "".join(cd.SENSE_CODONS[c] for c in row)] for row in ours])))
    np.testing.assert_array_equal(
        ours, jcd.simulate_gy94(key, _tree(1)[3], blens, kappa=2.5, omega=0.4,
                                n_sites=N_CODONS_SIM))
    key2 = jax.random.PRNGKey(9)
    np.testing.assert_array_equal(
        cd.simulate_gy94(_jax_seed(key2), topo, blens, kappa=1.5, omega=2.0, freqs=freqs,
                         n_sites=N_CODONS_SIM),
        jcd.simulate_gy94(key2, _tree(1)[3], blens, kappa=1.5, omega=2.0, freqs=freqs,
                          n_sites=N_CODONS_SIM))
