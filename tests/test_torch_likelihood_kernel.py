"""Parity of K3/K4's plain version (``batched_log_likelihood_plain``) with
trex_tpu's ``batched_log_likelihood_pallas`` (interpret mode) and lax
``tree_log_likelihood``, plus the wrapper's no-fall-back guards.

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
from trex_tpu_torch.ops.likelihood import jc69_transition
from trex_tpu_torch.ops.likelihood_cuda import (
    batched_log_likelihood_cuda,
    batched_log_likelihood_plain,
)

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


def test_plain_matches_slots_per_branch():
    children, masks, weights, blens = _inputs(0)
    ref = batched_log_likelihood_pallas(
        _jax_topos(children), jnp.asarray(blens), jnp.asarray(masks), 4,
        site_weights=jnp.asarray(weights), sequences_are_masks=True,
        layout="slots", interpret=True,
    )
    ours = _plain(children, masks, weights, jc69_transition(torch.as_tensor(blens), 4))
    np.testing.assert_allclose(ours, np.asarray(ref), rtol=2e-5)


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
    with pytest.raises(ValueError, match="Q in"):
        batched_log_likelihood_cuda(ch, m, w, torch.full((3,), 1 / 3), jc69_transition(0.1, 3))
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
