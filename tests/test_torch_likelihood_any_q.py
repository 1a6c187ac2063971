"""K3/K4 at any state count: the plain version (``batched_log_likelihood_plain``,
the CPU path and the kernel's yardstick) at Q = 2, 3, 5, 7, 13 and 61 against the
JAX package's lax ``per_site_log_likelihood`` (and their weighted sums,
its ``tree_log_likelihood``),
under one shared P and under a P per branch, on states with missing data and
(Q = 5) on masks; and the launch plan at every Q: the fixed kernels'
zero-padded widths up to 20 states, the runtime-Q kernel above. The ML NNI
climb at Q = 61: ``test_torch_ml_any_q.py``; the padding itself:
``test_torch_likelihood_pad.py``.

Tolerance rtol 2e-5, the reference's own: the power-of-two rescaling is
exact, and torch's ``matrix_exp`` and JAX's ``expm`` differ by about 1e-7.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import integer_weights, parents_of, random_children

from trex_tpu.ops.likelihood import per_site_log_likelihood as jax_per_site
from trex_tpu.topology import Topology as JaxTopology
from trex_tpu_torch.ops.likelihood import gtr_generator
from trex_tpu_torch.ops.likelihood_cuda import (
    batched_log_likelihood_plain,
    kernel_width,
    launch_plan,
)
from trex_tpu_torch.ops.tree_plan import SlotPlan

N_LEAVES, BATCH = 6, 3


@functools.cache
def _jax_rows(q, masks):
    """JAX's lax per-site log-likelihoods, jitted once per (Q, masks)."""
    return jax.jit(lambda topo, blens, leaves, rates, freqs: jax_per_site(
        topo, blens, leaves, q, rates, freqs, sequences_are_masks=masks))


def _model(rng, q):
    rates = rng.gamma(2.0, 1.0, (q, q))
    rates = ((rates + rates.T) / 2).astype(np.float32)
    freqs = rng.dirichlet(np.full(q, 5.0)).astype(np.float32)
    return rates, freqs


def _inputs(seed, q, length, masks):
    rng = np.random.default_rng(seed)
    children = random_children(rng, N_LEAVES, BATCH)
    if masks:
        leaves = rng.integers(1, 1 << q, (N_LEAVES, length)).astype(np.int32)
    else:
        leaves = rng.integers(0, q, (N_LEAVES, length)).astype(np.int32)
        leaves[rng.random(leaves.shape) < 0.05] = -1
    weights = integer_weights(rng, length)
    blens = rng.uniform(0.02, 0.6, (BATCH, 2 * N_LEAVES - 1)).astype(np.float32)
    return children, leaves, weights, blens, *_model(rng, q)


@pytest.mark.parametrize("q, masks", [(2, False), (3, False), (5, False), (5, True),
                                      (7, False), (13, False), (61, False)])
@pytest.mark.parametrize("per_branch", [False, True])
def test_plain_matches_lax_at_any_q(q, masks, per_branch):
    length = 40 if q == 61 else 96
    children, leaves, weights, blens, rates, freqs = _inputs(q + 7 * masks, q, length, masks)
    if not per_branch:
        blens = np.full_like(blens, 0.1)
    gen = gtr_generator(torch.as_tensor(rates), torch.as_tensor(freqs))
    lengths = torch.as_tensor(blens)
    transition = (torch.linalg.matrix_exp(gen * lengths[..., None, None]).contiguous()
                  if per_branch else torch.linalg.matrix_exp(gen * 0.1))
    sums, rows = batched_log_likelihood_plain(
        torch.as_tensor(children), torch.as_tensor(leaves), torch.as_tensor(weights),
        torch.as_tensor(freqs), transition, sequences_are_masks=masks, per_site=True)
    for b in range(BATCH):
        topo = JaxTopology(jnp.asarray(children[b]), jnp.asarray(parents_of(children[b])))
        want = np.asarray(_jax_rows(q, masks)(topo, jnp.asarray(blens[b]), jnp.asarray(leaves),
                                              jnp.asarray(rates), jnp.asarray(freqs)))
        np.testing.assert_allclose(rows[b].numpy(), want, rtol=2e-5)
        # tree_log_likelihood is the weighted sum of these rows.
        np.testing.assert_allclose(float(sums[b]), float((want * weights).sum()), rtol=2e-5)


@pytest.mark.parametrize(
    "n_leaves, q, shared_p, masks, width, plan",
    [
        # chip_smoke's runtime-Q shapes on an H100 (232,448 bytes of opt-in
        # shared memory). Q = 61: P in (64, 64) floats, each tile's rows 4
        # floats on (16,640 bytes), two threads a site (four tiles, two
        # sites a thread), slot rows of 64 states. The dnds batch at 64
        # taxa under a shared P with the leaf table; a P per branch (two
        # buffers of two matrices) leaves 128 threads an SM beside the
        # slots, so its slots go to global memory at the same width; the
        # 512-taxon batch (64 sites: 128 would take 295 KB of slots).
        (64, 61, True, False, 0, SlotPlan("shared", 6, 128, 229184, 256, 2, True)),
        (64, 61, False, False, 0, SlotPlan("global", 6, 64, 65792, 384, 2, False)),
        (512, 61, True, False, 0, SlotPlan("shared", 9, 64, 180032, 128, 2, True)),
        # Q = 5 runs the width-8 fixed kernel: P padded to (8, 8), 7 leaf
        # codes, or 256 for masks of 8 bits.
        (64, 5, True, False, 8, SlotPlan("shared", 6, 128, 25152, 1024, 1, True)),
        (64, 5, True, True, 8, SlotPlan("shared", 6, 128, 33024, 768, 1, True)),
        # A shared P of 230 states fills most of a block: no leaf table, and
        # no width holds the slots, so they go to global memory.
        (64, 230, True, False, 0, SlotPlan("global", 6, 32, 230640, 256, 8, False)),
        # Each fixed width class, and a P per branch at Q = 5 (the Q = 5
        # sampler's mode).
        (64, 2, True, False, 4, SlotPlan("shared", 6, 128, 12448, 2048, 1, True)),
        (64, 3, True, True, 4, SlotPlan("shared", 6, 128, 12608, 2048, 1, True)),
        (64, 7, True, True, 8, SlotPlan("shared", 6, 128, 33024, 768, 1, True)),
        (64, 5, False, False, 8, SlotPlan("shared", 6, 128, 24576, 1152, 1, False)),
        (64, 11, True, False, 12, SlotPlan("shared", 6, 128, 38112, 640, 1, True)),
        (64, 13, False, False, 16, SlotPlan("shared", 6, 128, 49152, 512, 1, False)),
        (64, 19, True, True, 20, SlotPlan("shared", 6, 128, 63040, 384, 1, False)),
        # The runtime-Q classes: Q = 21 (pitch 32, one thread a site), 40
        # (pitch 64, a fourth lane idle), 100 (a runtime pitch, eight lanes).
        (64, 21, True, False, 0, SlotPlan("shared", 6, 128, 105376, 256, 1, True)),
        (64, 21, True, True, 0, SlotPlan("shared", 6, 128, 102432, 256, 1, False)),
        (64, 40, False, False, 0, SlotPlan("shared", 6, 128, 196800, 256, 2, False)),
        (64, 100, True, False, 0, SlotPlan("shared", 6, 32, 182000, 128, 4, True)),
        # Q = 61 with a P per branch at 512 taxa: the global-slot mode.
        (512, 61, False, False, 0, SlotPlan("global", 9, 64, 65792, 384, 2, False)),
    ],
)
def test_runtime_q_launch_plan(n_leaves, q, shared_p, masks, width, plan):
    assert kernel_width(q) == width
    assert launch_plan(n_leaves, q, shared_p, masks, 232448) == plan


def test_runtime_q_launch_plan_refuses_a_p_beyond_shared_memory():
    with pytest.raises(ValueError, match="do not fit"):
        launch_plan(64, 250, True, False, 232448)
    # A P per branch holds four matrices: at 113 states 262,656 bytes.
    assert launch_plan(64, 112, False, False, 232448).mode == "global"
    with pytest.raises(ValueError, match="do not fit"):
        launch_plan(64, 113, False, False, 232448)
