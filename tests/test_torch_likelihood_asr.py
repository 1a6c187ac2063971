"""Parity of the port's inside-outside passes and Newton branch-length fit
(``trex_tpu_torch.ops.likelihood_asr``) with trex_tpu's.

Tolerances: derivatives rtol 1e-4 (ratios of float32 contractions summed in
another order; the reference holds its own analytic gradient to autodiff at
a looser ~1%); Newton NLL curve rtol 2e-5, fitted lengths atol 1e-3.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import evolved_masks, integer_weights, parents_of, random_children

from trex_tpu.ops import likelihood_asr as ja
from trex_tpu.topology import Topology as JaxTopology
from trex_tpu_torch.ops import likelihood_asr as ta
from trex_tpu_torch.topology import from_numpy

N_LEAVES, LENGTH = 12, 200


def _inputs(seed):
    rng = np.random.default_rng(seed)
    children = random_children(rng, N_LEAVES, 1)[0]
    masks = evolved_masks(rng, children, LENGTH, 0.15)
    masks[rng.random(masks.shape) < 0.05] = 15  # N / gaps
    weights = integer_weights(rng, LENGTH)
    blens = rng.uniform(0.05, 0.6, 2 * N_LEAVES - 1).astype(np.float32)
    parents = parents_of(children)
    return (
        from_numpy(children, parents),
        JaxTopology(jnp.asarray(children), jnp.asarray(parents)),
        masks, weights, blens,
    )


def test_branch_length_gradients_match_jax():
    ours_topo, jax_topo, masks, weights, blens = _inputs(0)
    ours = ta.branch_length_gradients(
        ours_topo, torch.as_tensor(blens), torch.as_tensor(masks), 4,
        site_weights=torch.as_tensor(weights), sequences_are_masks=True,
    )
    ref = ja.branch_length_gradients(
        jax_topo, jnp.asarray(blens), jnp.asarray(masks), 4,
        site_weights=jnp.asarray(weights), sequences_are_masks=True,
    )
    assert float(ours[-1]) == 0.0
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-3)


def test_branch_curvatures_match_jax():
    ours_topo, jax_topo, masks, weights, blens = _inputs(1)
    grad, hess = ta._branch_curvatures(
        ours_topo, torch.as_tensor(blens), torch.as_tensor(masks), 4,
        None, None, torch.as_tensor(weights), True,
    )
    ref_grad, ref_hess = ja._branch_curvatures(
        jax_topo, jnp.asarray(blens), jnp.asarray(masks), 4,
        None, None, jnp.asarray(weights), True,
    )
    np.testing.assert_allclose(grad.numpy(), np.asarray(ref_grad), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(hess.numpy(), np.asarray(ref_hess), rtol=1e-4, atol=1e-2)
    assert float(hess[-1]) == -1.0


@pytest.mark.parametrize("model", ["jc", "gtr"])
def test_newton_fit_matches_jax(model):
    ours_topo, jax_topo, masks, weights, _ = _inputs(2)
    rates = freqs = None
    if model == "gtr":
        rng = np.random.default_rng(9)
        rates = np.abs(rng.normal(1.0, 0.4, (4, 4))).astype(np.float32)
        rates = (rates + rates.T) / 2
        freqs = rng.dirichlet(np.full(4, 3.0)).astype(np.float32)
    lengths, curve = ta.optimize_branch_lengths_newton(
        ours_topo, torch.as_tensor(masks), 4,
        None if rates is None else torch.as_tensor(rates),
        None if freqs is None else torch.as_tensor(freqs),
        site_weights=torch.as_tensor(weights), sequences_are_masks=True,
    )
    ref_lengths, ref_curve = ja.optimize_branch_lengths_newton(
        jax_topo, jnp.asarray(masks), 4,
        None if rates is None else jnp.asarray(rates),
        None if freqs is None else jnp.asarray(freqs),
        site_weights=jnp.asarray(weights), sequences_are_masks=True,
    )
    assert curve.shape == (13,) and lengths.shape == (2 * N_LEAVES - 1,)
    assert lengths.dtype == torch.float32
    np.testing.assert_allclose(curve.numpy(), np.asarray(ref_curve), rtol=2e-5)
    np.testing.assert_allclose(lengths.numpy(), np.asarray(ref_lengths), atol=1e-3)
    assert float(lengths[-1]) == pytest.approx(0.1)
    assert np.all(np.diff(curve.numpy()) <= 0)
