"""The partitioned ML search on the CPU: ``likelihood_spr_scan_segmented``
(bit-equal to the port's one-call scan, within rtol 2e-5 of JAX's
segmented scan), ``ml_partitioned_scan_climb`` against JAX's (the same
topology, rounds and evaluations)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import evolved_masks, parents_of, random_children

import trex_tpu.ops.likelihood_scan as jax_scan
import trex_tpu.search.ml as jax_ml
import trex_tpu_torch.ops.likelihood_scan as torch_scan
import trex_tpu_torch.search.ml as torch_ml
from trex_tpu.topology import Topology as JaxTopology
from trex_tpu_torch.topology import from_numpy


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(7)
    masks = evolved_masks(rng, random_children(rng, 8, 1)[0], 60, 0.3)
    children = random_children(rng, 8, 1)[0]
    return masks, children, parents_of(children)


@pytest.mark.parametrize("mixture", [{}, {"gamma_shape": 0.7}], ids=["jc", "gamma"])
def test_segmented_scan_equals_full_scan_and_jax(case, mixture):
    masks, children, parents = case
    topo = from_numpy(children, parents)
    leaves = torch.as_tensor(masks)
    full, base = torch_scan.likelihood_spr_scan(topo, leaves, 4, 0.1, None,
                                                sequences_are_masks=True, **mixture)
    # 40 cells: segments of 2 prune nodes over the 15 x 15 table.
    seg, seg_base = torch_scan.likelihood_spr_scan_segmented(
        topo, leaves, 4, 0.1, None, sequences_are_masks=True, max_cells=40, **mixture)
    assert seg.shape == (15, 15) and torch.equal(seg, full) and torch.equal(seg_base, base)
    assert torch.isinf(seg[-1]).all()
    ref, ref_base = jax_scan.likelihood_spr_scan_segmented(
        JaxTopology(jnp.asarray(children), jnp.asarray(parents)), jnp.asarray(masks), 4, 0.1,
        None, sequences_are_masks=True, max_cells=40, **mixture)
    ref = np.asarray(ref)
    finite = np.isfinite(ref)
    np.testing.assert_array_equal(np.isfinite(seg.numpy()), finite)
    np.testing.assert_allclose(seg.numpy()[finite], ref[finite], rtol=2e-5)
    np.testing.assert_allclose(float(seg_base), float(ref_base), rtol=2e-5)


def test_partitioned_scan_climb_matches_jax(case):
    masks, children, parents = case
    rates = np.array([[0, 1, 3, 1], [1, 0, 1, 3], [3, 1, 0, 1], [1, 3, 1, 0]], np.float32)
    freqs = np.array([0.3, 0.2, 0.2, 0.3], np.float32)
    specs = [dict(cols=slice(0, 30), rates=rates, freqs=freqs, gamma_shape=None, mult=1.0),
             dict(cols=slice(30, 60), rates=None, freqs=None, gamma_shape=0.8, mult=2.0)]

    def parts(array):
        return [dict(leaf_sequences=array(masks[:, s["cols"]]),
                     rates=None if s["rates"] is None else array(s["rates"]),
                     freqs=None if s["freqs"] is None else array(s["freqs"]),
                     gamma_shape=s["gamma_shape"], rate_multiplier=s["mult"]) for s in specs]

    ref = jax_ml.ml_partitioned_scan_climb(
        JaxTopology(jnp.asarray(children), jnp.asarray(parents)), parts(jnp.asarray), 4,
        sequences_are_masks=True)
    timings = {}
    ours = torch_ml.ml_partitioned_scan_climb(
        from_numpy(children, parents), parts(lambda x: torch.as_tensor(np.array(x))), 4,
        sequences_are_masks=True, timings=timings)
    assert np.array_equal(ours.topology.children.numpy(), np.asarray(ref.topology.children))
    assert (ours.rounds, ours.evaluations) == (ref.rounds, ref.evaluations)
    assert ours.rounds > 0
    np.testing.assert_allclose(ours.trace, ref.trace, rtol=2e-5)
    assert len(timings["scan_rounds"]) == ours.rounds + 1
