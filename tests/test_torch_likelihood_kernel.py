"""Parity of K3/K4's plain version (``batched_log_likelihood_plain``) with
trex_tpu's ``batched_log_likelihood_pallas`` (interpret mode) and lax
``tree_log_likelihood``; a model of the kernel's walk (the tree plan over a
slot stack) against both; the wrapper's launch plan and no-fall-back
guards.

Tolerance rtol 2e-5, the reference's own (``tests/test_likelihood_pallas.py``):
the power-of-two rescaling is exact, so the versions differ only in float32
summation order and in the rounding of the final log.
"""

import ast
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import integer_weights, parents_of, random_children, random_masks

from trex_tpu.ops.likelihood import jc69_transition as jax_jc69
from trex_tpu.ops.likelihood import tree_log_likelihood as jax_tree_ll
from trex_tpu.ops.likelihood_pallas import batched_log_likelihood_pallas
from trex_tpu.topology import Topology as JaxTopology
from trex_tpu_torch.ops import likelihood_cuda
from trex_tpu_torch.ops.likelihood import jc69_transition, tip_partials
from trex_tpu_torch.ops.likelihood_cuda import (
    batched_log_likelihood_cuda,
    batched_log_likelihood_plain,
    launch_plan,
)
from trex_tpu_torch.ops.tree_plan import SlotPlan, slots_for, tree_plan_plain

N_LEAVES, LENGTH, BATCH = 8, 128, 4
UNIFORM = torch.full((4,), 0.25)


def _inputs(seed):
    rng = np.random.default_rng(seed)
    children = random_children(rng, N_LEAVES, BATCH)
    masks = random_masks(rng, N_LEAVES, LENGTH, ambiguity=0.1)
    weights = integer_weights(rng, LENGTH)
    blens = rng.uniform(0.05, 1.0, (BATCH, 2 * N_LEAVES - 1)).astype(np.float32)
    return children, masks, weights, blens


def _jax_topos(children):
    return JaxTopology(jnp.asarray(children), jnp.asarray(parents_of(children)))


def _plain(children, leaves, weights, transition, masks=True):
    return batched_log_likelihood_plain(
        torch.as_tensor(children), torch.as_tensor(leaves), torch.as_tensor(weights),
        UNIFORM, transition, sequences_are_masks=masks,
    ).numpy()


def _planned(children, leaves, weights, transition, masks=True):
    """(B,) log-likelihoods of a model of the kernel's walk: the plain tree
    plan run over a (B, slots, Q, L) slot stack, P of each child's branch
    taken by its node id, the root's partial never stored."""
    children, leaves, weights = (torch.as_tensor(x) for x in (children, leaves, weights))
    batch, n_anc, _ = children.shape
    q, length = 4, leaves.shape[1]
    tips = tip_partials(leaves, q, masks)
    plan = tree_plan_plain(children).long()
    slots = torch.full((batch, slots_for(n_anc + 1), q, length), float("nan"))
    exp_sum = torch.zeros((batch, length), dtype=torch.int32)
    rows = torch.arange(batch)

    def message(src, node):
        d = torch.where((src >= 0)[:, None, None], tips[src.clamp(min=0)],
                        slots[rows, (~src).clamp(min=0)])
        p = transition if transition.dim() == 2 else transition[rows, node]
        return torch.matmul(p, d)

    for k in range(n_anc):
        v, src1, src2, dst = plan[:, k].T
        nodes = children[rows, v].long()
        combined = message(src1, nodes[:, 0]) * message(src2, nodes[:, 1])
        e = combined.amax(dim=1).view(torch.int32) >> 23
        part = combined * ((254 - e) << 23).view(torch.float32)[:, None, :]
        exp_sum += e - 127
        if k + 1 < n_anc:
            slots[rows, dst] = part
    site_lik = (UNIFORM[None, :, None] * part).sum(dim=1)
    per_site = torch.log(torch.clamp(site_lik, min=1e-30)) + exp_sum.float() * 0.6931471805599453
    return (per_site * weights).sum(dim=-1).numpy()


def test_plain_matches_slots_per_branch():
    children, masks, weights, blens = _inputs(0)
    ref = batched_log_likelihood_pallas(
        _jax_topos(children), jnp.asarray(blens), jnp.asarray(masks), 4,
        site_weights=jnp.asarray(weights), sequences_are_masks=True,
        layout="slots", interpret=True,
    )
    p = jc69_transition(torch.as_tensor(blens), 4)
    ours = _plain(children, masks, weights, p)
    np.testing.assert_allclose(ours, np.asarray(ref), rtol=2e-5)
    planned = _planned(children, masks, weights, p)
    np.testing.assert_allclose(planned, ours, rtol=1e-6)
    np.testing.assert_allclose(planned, np.asarray(ref), rtol=2e-5)


@pytest.mark.parametrize(
    "layout, extra",
    [("slots", {}), ("lanes", dict(trees_per_block=4, rescale_every=4))],
)
def test_plain_matches_shared_p_layouts(layout, extra):
    children, masks, weights, _ = _inputs(1)
    ref = batched_log_likelihood_pallas(
        _jax_topos(children), jnp.full((BATCH, 2 * N_LEAVES - 1), 0.1), jnp.asarray(masks), 4,
        shared_transition=jax_jc69(jnp.float32(0.1), 4),
        site_weights=jnp.asarray(weights), sequences_are_masks=True,
        layout=layout, interpret=True, **extra,
    )
    ours = _plain(children, masks, weights, jc69_transition(0.1, 4))
    np.testing.assert_allclose(ours, np.asarray(ref), rtol=2e-5)
    planned = _planned(children, masks, weights, jc69_transition(0.1, 4))
    np.testing.assert_allclose(planned, ours, rtol=1e-6)
    np.testing.assert_allclose(planned, np.asarray(ref), rtol=2e-5)


@pytest.mark.parametrize("mode", ["masks", "states"])
def test_plain_matches_tree_log_likelihood(mode):
    children, masks, weights, blens = _inputs(2)
    if mode == "states":
        leaves = np.random.default_rng(3).integers(-1, 4, masks.shape).astype(np.int32)
    else:
        leaves = masks
    ours = _plain(
        children, leaves, weights, jc69_transition(torch.as_tensor(blens), 4),
        masks=mode == "masks",
    )
    for b in range(BATCH):
        ref = jax_tree_ll(
            JaxTopology(jnp.asarray(children[b]), jnp.asarray(parents_of(children[b]))),
            jnp.asarray(blens[b]), jnp.asarray(leaves), 4,
            site_mask=jnp.asarray(weights), sequences_are_masks=mode == "masks",
        )
        np.testing.assert_allclose(ours[b], float(ref), rtol=2e-5)


@pytest.mark.parametrize("per_branch", [False, True])
def test_plan_walk_matches_plain_on_deep_trees(per_branch):
    # 40 taxa, one tree a caterpillar; states with 5% missing.
    rng = np.random.default_rng(5)
    children = random_children(rng, 40, 3)
    children[0] = [(0, 1)] + [(40 + a - 1, a + 1) for a in range(1, 39)]
    states = rng.integers(-1, 4, (40, 100)).astype(np.int32)
    weights = integer_weights(rng, 100)
    if per_branch:
        p = jc69_transition(torch.as_tensor(rng.uniform(0.05, 1.0, (3, 79)).astype(np.float32)), 4)
    else:
        p = jc69_transition(0.3, 4)
    np.testing.assert_allclose(
        _planned(children, states, weights, p, masks=False),
        _plain(children, states, weights, p, masks=False), rtol=1e-6)


@pytest.mark.parametrize(
    "n_leaves, q, shared_p, masks, plan",
    [
        # chip_smoke's shapes, on an H100 (232,448 bytes of opt-in shared
        # memory): P, the leaf-message table (shared P), the slot columns.
        (64, 4, True, False, SlotPlan("shared", 6, 128, 12448, 2048, 1, True)),
        (512, 4, True, True, SlotPlan("shared", 9, 128, 18752, 1408, 1, True)),
        (64, 4, False, False, SlotPlan("shared", 6, 128, 12288, 2048, 1, False)),
        (2048, 20, False, False, SlotPlan("shared", 11, 128, 112640, 256, 1, False)),
    ],
)
def test_launch_plan(n_leaves, q, shared_p, masks, plan):
    assert launch_plan(n_leaves, q, shared_p, masks, 232448) == plan


def test_plain_protein_states_are_finite():
    rng = np.random.default_rng(4)
    children = random_children(rng, 6, 2)
    leaves = rng.integers(0, 20, (6, 40)).astype(np.int32)
    out = batched_log_likelihood_plain(
        torch.as_tensor(children), torch.as_tensor(leaves), torch.ones(40),
        torch.full((20,), 0.05), jc69_transition(0.2, 20),
    )
    assert out.shape == (2,) and torch.isfinite(out).all() and (out < 0).all()


def test_cpu_wrapper_runs_plain_and_counts_no_launch():
    children, masks, weights, blens = _inputs(5)
    args = (torch.as_tensor(children), torch.as_tensor(masks), torch.as_tensor(weights), UNIFORM)
    before = batched_log_likelihood_cuda.launches
    for transition in (jc69_transition(0.1, 4), jc69_transition(torch.as_tensor(blens), 4)):
        np.testing.assert_array_equal(
            batched_log_likelihood_cuda(*args, transition, sequences_are_masks=True).numpy(),
            batched_log_likelihood_plain(*args, transition, sequences_are_masks=True).numpy(),
        )
    assert batched_log_likelihood_cuda.launches == before


def test_wrapper_rejects_what_the_kernel_does_not_take():
    children, masks, weights, _ = _inputs(6)
    ch, m, w = (torch.as_tensor(x) for x in (children, masks, weights))
    p = jc69_transition(0.1, 4)
    # Any Q >= 2 is taken; Q = 1, and a prior whose length disagrees with P, are not.
    with pytest.raises(ValueError, match="Q >= 2"):
        batched_log_likelihood_cuda(ch, m, w, torch.ones((1,)), torch.ones((1, 1)))
    with pytest.raises(ValueError, match="transition must be"):
        batched_log_likelihood_cuda(ch, m, w, torch.full((3,), 1 / 3), p)
    with pytest.raises(ValueError, match="transition must be"):
        batched_log_likelihood_cuda(ch, m, w, UNIFORM, p[None])
    with pytest.raises(ValueError, match="transition must be"):
        batched_log_likelihood_cuda(ch, m, w, UNIFORM, p.expand(BATCH, 7, 4, 4))
    with pytest.raises(TypeError):
        batched_log_likelihood_cuda(ch.long(), m, w, UNIFORM, p)
    with pytest.raises(TypeError):
        batched_log_likelihood_cuda(ch, m, w, UNIFORM, p.double())
    with pytest.raises(ValueError):
        batched_log_likelihood_cuda(ch, m[:-1], w, UNIFORM, p)


def test_wrapper_has_no_fallback_around_the_launch():
    tree = ast.parse(inspect.getsource(likelihood_cuda))
    assert not any(isinstance(node, ast.Try) for node in ast.walk(tree))
    source = inspect.getsource(batched_log_likelihood_cuda)
    launch = source.index("trex_likelihood_batched(")
    # The plain version is reached only from the CPU branch, before the launch.
    assert source.rindex("batched_log_likelihood_plain(") < launch
    assert 'device.type == "cpu"' in source[: source.index("batched_log_likelihood_plain(")]
