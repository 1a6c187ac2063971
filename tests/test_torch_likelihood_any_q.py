"""K3/K4 at any state count: the plain version (``batched_log_likelihood_plain``,
the CPU path and the kernel's yardstick) at Q = 2, 3, 5 and 61 against the
JAX package's lax ``per_site_log_likelihood`` (and their weighted sums,
its ``tree_log_likelihood``),
under one shared P and under a P per branch, on states with missing data and
(Q = 5) on masks; and the runtime-Q kernel's launch plan. The ML NNI climb
at Q = 61: ``test_torch_ml_any_q.py``.

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
from trex_tpu_torch.ops.likelihood_cuda import batched_log_likelihood_plain, launch_plan
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
                                      (61, False)])
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
    "n_leaves, q, shared_p, masks, plan",
    [
        # chip_smoke's runtime-Q shapes on an H100 (232,448 bytes of opt-in
        # shared memory): the dnds batch at 64 taxa, shared P with the leaf
        # table and per branch; the 512-taxon batch (64 sites: 128 would
        # take 283 KB of slots); Q = 5 on states and masks.
        (64, 61, True, False, SlotPlan("shared", 6, 128, 221184, 512, 4, True)),
        (64, 61, False, False, SlotPlan("shared", 6, 128, 189440, 512, 4, False)),
        (512, 61, True, False, SlotPlan("shared", 9, 64, 173312, 256, 4, True)),
        (64, 5, True, False, SlotPlan("shared", 6, 128, 16640, 1664, 1, True)),
        (64, 5, True, True, SlotPlan("shared", 6, 128, 16192, 1664, 1, False)),
        # A shared P of 230 states fills most of a block: no leaf table, and
        # no width holds the slots, so they go to global memory.
        (64, 230, True, False, SlotPlan("global", 6, 32, 222720, 480, 15, False)),
    ],
)
def test_runtime_q_launch_plan(n_leaves, q, shared_p, masks, plan):
    assert launch_plan(n_leaves, q, shared_p, masks, 232448) == plan


def test_runtime_q_launch_plan_refuses_a_p_beyond_shared_memory():
    with pytest.raises(ValueError, match="do not fit"):
        launch_plan(64, 250, True, False, 232448)
