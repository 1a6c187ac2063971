"""Parity of the port's analytic ML SPR scan (``trex_tpu_torch.ops.likelihood_scan``)
with trex_tpu's.

The same (n_all, n_all) table: +inf at the same pairs, finite values within
rtol 2e-5 (float32 contractions summed in another order), and the same best
move — the first minimum of the table — however the prune axis is cut into
segments and chunks.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import integer_weights, parents_of, random_children, random_masks

from trex_tpu.ops import likelihood_scan as js
from trex_tpu.topology import Topology as JaxTopology
from trex_tpu_torch.ops import likelihood_scan as ts
from trex_tpu_torch.topology import from_numpy

N_LEAVES, LENGTH = 11, 120


def _inputs(seed):
    rng = np.random.default_rng(seed)
    children = random_children(rng, N_LEAVES, 1)[0]
    masks = random_masks(rng, N_LEAVES, LENGTH, ambiguity=0.1)
    weights = integer_weights(rng, LENGTH)
    parents = parents_of(children)
    return (
        from_numpy(children, parents),
        JaxTopology(jnp.asarray(children), jnp.asarray(parents)),
        masks, weights,
    )


def _gtr():
    rng = np.random.default_rng(11)
    rates = np.abs(rng.normal(1.0, 0.5, (4, 4))).astype(np.float32)
    return (rates + rates.T) / 2, rng.dirichlet(np.full(4, 2.0)).astype(np.float32)


@pytest.mark.parametrize("model", ["jc", "gtr"])
def test_scan_table_matches_jax(model):
    ours_topo, jax_topo, masks, weights = _inputs(0 if model == "jc" else 1)
    rates, freqs = _gtr() if model == "gtr" else (None, None)
    ours, ours_base = ts.likelihood_spr_scan(
        ours_topo, torch.as_tensor(masks), 4, 0.1, torch.as_tensor(weights),
        rates=None if rates is None else torch.as_tensor(rates),
        freqs=None if freqs is None else torch.as_tensor(freqs),
        sequences_are_masks=True, prune_chunk=4,
    )
    ref, ref_base = js.likelihood_spr_scan(
        jax_topo, jnp.asarray(masks), 4, 0.1, jnp.asarray(weights),
        rates=None if rates is None else jnp.asarray(rates),
        freqs=None if freqs is None else jnp.asarray(freqs),
        sequences_are_masks=True,
    )
    ours, ref = ours.numpy(), np.asarray(ref)
    assert ours.shape == ref.shape == (2 * N_LEAVES - 1,) * 2
    finite = np.isfinite(ref)
    np.testing.assert_array_equal(np.isfinite(ours), finite)
    np.testing.assert_allclose(ours[finite], ref[finite], rtol=2e-5)
    np.testing.assert_allclose(float(ours_base), float(ref_base), rtol=2e-5)
    assert int(np.argmin(ours)) == int(np.argmin(ref))


@pytest.mark.parametrize("max_cells", [None, 3 * (2 * N_LEAVES - 1)])
def test_best_segmented_picks_the_same_move(max_cells):
    ours_topo, jax_topo, masks, weights = _inputs(2)
    best, p, v, base, n_finite = ts.likelihood_spr_scan_best_segmented(
        ours_topo, torch.as_tensor(masks), 4, 0.1, torch.as_tensor(weights),
        sequences_are_masks=True, max_cells=max_cells, prune_chunk=2,
    )
    ref = js.likelihood_spr_scan_best_segmented(
        jax_topo, jnp.asarray(masks), 4, 0.1, jnp.asarray(weights),
        sequences_are_masks=True,
    )
    assert (p, v, n_finite) == (ref[1], ref[2], ref[4])
    np.testing.assert_allclose([best, base], [ref[0], ref[3]], rtol=2e-5)
