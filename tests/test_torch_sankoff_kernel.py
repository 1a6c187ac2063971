"""Parity of K5's plain version (``batched_sankoff_score_plain``) with
trex_tpu's ``batched_sankoff_score_pallas`` (interpret mode, as
``tests/test_pallas_parity.py`` runs it) and lax ``sankoff_score``; a model
of the kernel's walk (the tree plan over a slot stack) against both; the
wrapper's launch plan and guards.

Bit-equal throughout: costs are integer or dyadic and weights integer, so
every DP value and partial sum is exact in float32 and the summation
orders of the packages cannot differ in the result.
"""

import ast
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import integer_weights, parents_of, random_children, random_masks

from trex_tpu.ops.sankoff import sankoff_score as jax_sankoff_score
from trex_tpu.ops.sankoff_pallas import batched_sankoff_score_pallas
from trex_tpu.topology import Topology as JaxTopology
from trex_tpu_torch.ops import sankoff_cuda
from trex_tpu_torch.ops.sankoff import _hamming_messages, _minplus_min, leaf_dp
from trex_tpu_torch.ops.sankoff_cuda import (
    batched_sankoff_score_cuda,
    batched_sankoff_score_plain,
    launch_plan,
    ordered_site_sum,
)
from trex_tpu_torch.ops.tree_plan import SlotPlan, slots_for, tree_plan_plain

N_LEAVES, BATCH = 8, 3


def _jax_topos(children):
    return JaxTopology(jnp.asarray(children), jnp.asarray(parents_of(children)))


def _plain(children, leaves, cost, weights, **kw):
    return batched_sankoff_score_plain(
        torch.as_tensor(children), torch.as_tensor(leaves), torch.as_tensor(cost),
        torch.as_tensor(weights), **kw,
    ).numpy()


def _planned(children, leaves, cost, weights, hamming=False, masks=False):
    """(B,) scores of a model of the kernel's walk: the plain tree plan run
    over a (B, slots, Q, L) slot stack, leaf rows from the leaf table, the
    root's row never stored, the sites added in the kernel's order."""
    children, leaves, cost, weights = (
        torch.as_tensor(x) for x in (children, leaves, cost, weights))
    batch, n_anc, _ = children.shape
    q, length = cost.shape[0], leaves.shape[1]
    table = leaf_dp(leaves, q, masks)
    plan = tree_plan_plain(children).long()
    slots = torch.full((batch, slots_for(n_anc + 1), q, length), float("nan"))
    rows = torch.arange(batch)

    def row(src):
        leaf = table[src.clamp(min=0)]
        return torch.where((src >= 0)[:, None, None], leaf, slots[rows, (~src).clamp(min=0)])

    for k in range(n_anc):
        _, src1, src2, dst = plan[:, k].T
        child = torch.stack([row(src1), row(src2)], dim=1)
        msg = _hamming_messages(child) if hamming else _minplus_min(child, cost)
        total = msg[:, 0] + msg[:, 1]
        if k + 1 < n_anc:
            slots[rows, dst] = total
    return ordered_site_sum(total.amin(dim=1) * weights).numpy()


def _cost(rng, q, dyadic=False):
    cost = rng.integers(0, 4, (q, q)).astype(np.float32)
    if dyadic:
        cost = cost * 0.75 + 0.5
    np.fill_diagonal(cost, 0.0)
    return cost


@pytest.mark.parametrize(
    "q, length, hamming, dyadic",
    [
        (4, 256, False, False),  # general mode, aligned sites
        (4, 777, False, False),  # general mode, an unaligned length
        (20, 200, False, False),  # protein: the Q = 20 instantiation
        (7, 200, False, False),  # a Q of the runtime-Q kernel
        (4, 777, True, False),  # closed-form Hamming mode
        (4, 256, False, True),  # a dyadic non-integer cost
    ],
)
def test_plain_matches_pallas_interpret(q, length, hamming, dyadic):
    rng = np.random.default_rng(q + length)
    children = random_children(rng, N_LEAVES, BATCH)
    leaves = rng.integers(0, q, (N_LEAVES, length)).astype(np.int32)
    if hamming:
        cost = np.ones((q, q), np.float32) - np.eye(q, dtype=np.float32)
    else:
        cost = _cost(rng, q, dyadic)
    ref = batched_sankoff_score_pallas(
        _jax_topos(children), jnp.asarray(cost), jnp.asarray(leaves),
        hamming=hamming, interpret=True,
    )
    ones = np.ones(length, np.float32)
    ours = _plain(children, leaves, cost, ones, hamming=hamming)
    np.testing.assert_array_equal(ours, np.asarray(ref))
    np.testing.assert_array_equal(_planned(children, leaves, cost, ones, hamming), ours)


def test_plain_matches_pallas_on_compressed_patterns():
    rng = np.random.default_rng(11)
    children = random_children(rng, N_LEAVES, BATCH)
    leaves = rng.integers(0, 4, (N_LEAVES, 300)).astype(np.int32)
    weights = integer_weights(rng, 300)
    cost = _cost(rng, 4)
    ref = batched_sankoff_score_pallas(
        _jax_topos(children), jnp.asarray(cost), jnp.asarray(leaves),
        site_weights=jnp.asarray(weights), hamming=False, interpret=True,
    )
    np.testing.assert_array_equal(_plain(children, leaves, cost, weights), np.asarray(ref))


@pytest.mark.parametrize("hamming", [False, True])
def test_mask_mode_matches_lax(hamming):
    rng = np.random.default_rng(12)
    children = random_children(rng, N_LEAVES, BATCH)
    masks = random_masks(rng, N_LEAVES, 150, ambiguity=0.3)
    weights = integer_weights(rng, 150)
    cost = np.ones((4, 4), np.float32) - np.eye(4, dtype=np.float32) if hamming else _cost(rng, 4)
    ours = _plain(children, masks, cost, weights, hamming=hamming, sequences_are_masks=True)
    for b in range(BATCH):
        ref = jax_sankoff_score(
            _jax_topos(children[b]), jnp.asarray(cost), jnp.asarray(masks),
            site_mask=jnp.asarray(weights), hamming=hamming, sequences_are_masks=True,
        )
        assert ours[b] == float(ref)


@pytest.mark.parametrize("hamming, masks", [(False, False), (True, False), (False, True)])
def test_plan_walk_equals_plain_on_deep_trees(hamming, masks):
    # 40 taxa: random trees need 3-4 slots, where index order keeps up to
    # about 10 rows live; a caterpillar needs 1. Non-dyadic costs: exact
    # equality needs the kernel's rounded operations, not exactness.
    rng = np.random.default_rng(16)
    children = random_children(rng, 40, 3)
    children[0] = [(0, 1)] + [(40 + a - 1, a + 1) for a in range(1, 39)]
    leaves = random_masks(rng, 40, 150, 0.3) if masks else rng.integers(0, 5, (40, 150))
    cost = rng.random((5, 5)).astype(np.float32) * 3.0
    weights = rng.random(150).astype(np.float32) * 4.0
    if hamming:
        cost = np.ones((5, 5), np.float32) - np.eye(5, dtype=np.float32)
    if masks:
        cost = cost[:4, :4].copy()
    leaves = leaves.astype(np.int32)
    np.testing.assert_array_equal(
        _planned(children, leaves, cost, weights, hamming, masks),
        _plain(children, leaves, cost, weights, hamming=hamming, sequences_are_masks=masks),
    )


@pytest.mark.parametrize(
    "n_leaves, q, hamming, masks, plan",
    [
        # chip_smoke's shapes, on an H100 (232,448 bytes of opt-in shared
        # memory). Fixed Q: C, the leaf-message table, the slot columns.
        (512, 4, False, False, SlotPlan("shared", 9, 128, 18576, 1408, 1, True)),
        (512, 4, False, True, SlotPlan("shared", 9, 128, 18752, 1408, 1, True)),
        (2048, 4, True, False, SlotPlan("shared", 11, 128, 22672, 1152, 1, True)),
        (64, 20, False, False, SlotPlan("shared", 6, 128, 64720, 384, 1, True)),
        # Q = 20 masks: 2^20 masks, no table.
        (64, 20, False, True, SlotPlan("shared", 6, 128, 63040, 384, 1, False)),
        # Runtime Q: 4 threads a site at Q = 61, 8 at Q = 128; Q = 128 on
        # 2048 taxa needs 11 slots of 128 rows a site: the global-slot mode.
        (64, 61, False, False, SlotPlan("shared", 6, 128, 220928, 512, 4, True)),
        (64, 61, True, False, SlotPlan("shared", 6, 128, 189440, 512, 4, False)),
        (2048, 128, False, False, SlotPlan("global", 11, 64, 67584, 1536, 8, False)),
    ],
)
def test_launch_plan(n_leaves, q, hamming, masks, plan):
    assert launch_plan(n_leaves, q, hamming, masks, 232448) == plan


def test_ordered_site_sum_is_the_kernels_order():
    values = torch.tensor(np.random.default_rng(13).random((2, 300)), dtype=torch.float32)
    blocks = torch.zeros((2, 3, 128))
    blocks.view(2, -1)[:, :300] = values
    for stride in (64, 32, 16, 8, 4, 2, 1):
        blocks[..., :stride] = blocks[..., :stride] + blocks[..., stride : 2 * stride]
    want = (blocks[:, 0, 0] + blocks[:, 1, 0]) + blocks[:, 2, 0]
    assert torch.equal(ordered_site_sum(values), want)


def test_cpu_wrapper_runs_plain_and_counts_no_launch():
    rng = np.random.default_rng(14)
    children = random_children(rng, N_LEAVES, BATCH)
    leaves = rng.integers(0, 4, (N_LEAVES, 130)).astype(np.int32)
    weights = integer_weights(rng, 130)
    ones = np.ones((4, 4), np.float32) - np.eye(4, dtype=np.float32)
    before = batched_sankoff_score_cuda.launches
    for cost, hamming in ((_cost(rng, 4), False), (ones, True)):
        args = tuple(torch.as_tensor(x) for x in (children, leaves, cost, weights))
        got = batched_sankoff_score_cuda(*args)  # hamming=None: detected
        np.testing.assert_array_equal(
            got.numpy(), batched_sankoff_score_plain(*args, hamming=hamming).numpy()
        )
    assert batched_sankoff_score_cuda.launches == before


def test_wrapper_rejects_what_the_kernel_does_not_take():
    rng = np.random.default_rng(15)
    ch = torch.as_tensor(random_children(rng, N_LEAVES, BATCH))
    lv = torch.as_tensor(rng.integers(0, 4, (N_LEAVES, 40)).astype(np.int32))
    cost, w = torch.as_tensor(_cost(rng, 4)), torch.ones(40)
    with pytest.raises(TypeError):
        batched_sankoff_score_cuda(ch.long(), lv, cost, w)
    with pytest.raises(TypeError):
        batched_sankoff_score_cuda(ch, lv, cost.double(), w)
    with pytest.raises(ValueError, match="leaves must be"):
        batched_sankoff_score_cuda(ch, lv[:-1], cost, w)
    with pytest.raises(ValueError, match="cost must be"):
        batched_sankoff_score_cuda(ch, lv, cost[:3], w)
    with pytest.raises(ValueError, match="at most 32 states"):
        batched_sankoff_score_cuda(ch, lv, torch.zeros((40, 40)), w, sequences_are_masks=True)


def test_wrapper_has_no_fallback_around_the_launch():
    tree = ast.parse(inspect.getsource(sankoff_cuda))
    assert not any(isinstance(node, ast.Try) for node in ast.walk(tree))
    source = inspect.getsource(batched_sankoff_score_cuda)
    launch = source.index("trex_sankoff_batched(")
    # The plain version is reached only from the CPU branch, before the launch.
    assert source.rindex("batched_sankoff_score_plain(") < launch
    assert 'device.type == "cpu"' in source[: source.index("batched_sankoff_score_plain(")]
