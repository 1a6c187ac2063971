"""The tree plan of the tree-DP kernels K5 and K3/K4 (``ops.tree_plan``): its
plain version is a valid post-order that never overwrites a live slot and
uses at most floor(log2 n) slots, on random, caterpillar and balanced
trees; the wrapper's CPU path, launch shapes and guards.

The kernels' arithmetic over the plan is held to the plain versions and
the JAX package in ``tests/test_torch_sankoff_kernel.py`` and
``tests/test_torch_likelihood_kernel.py``.
"""

import ast
import inspect

import numpy as np
import pytest
import torch
from _torch_parity import random_children

from trex_tpu_torch.ops import tree_plan as tree_plan_module
from trex_tpu_torch.ops.tree_plan import (
    PlanLaunch,
    SlotPlan,
    plan_launch,
    slot_plan,
    slots_for,
    tree_plan,
    tree_plan_plain,
)


def _caterpillar(n):
    return np.array([(0, 1)] + [(n + a - 1, a + 1) for a in range(1, n - 1)], np.int32)


def _balanced(n):
    """Pairs taken from the front of a queue: balanced for n a power of two."""
    queue, pairs = list(range(n)), []
    while len(queue) > 1:
        pairs.append((queue.pop(0), queue.pop(0)))
        queue.append(n + len(pairs) - 1)
    return np.array(pairs, np.int32)


def _walk(children, plan):
    """Checks one tree's plan step by step; returns the slots it uses."""
    n_leaves = len(children) + 1
    live, done, used = {}, set(), 0
    for v, src1, src2, dst in plan.tolist():
        assert v not in done and 0 <= v < len(children)
        for c, src in zip(children[v].tolist(), (src1, src2)):
            if c < n_leaves:
                assert src == c  # a leaf names itself
            else:  # an ancestor child: done earlier, its row live in slot ~src
                assert src < 0 and live.get(~src) == c - n_leaves
        for c, src in zip(children[v].tolist(), (src1, src2)):
            if c >= n_leaves:
                del live[~src]
        assert dst not in live  # never overwrites a live row
        live[dst] = v
        done.add(v)
        used = max(used, dst + 1)
    assert len(done) == len(children) and plan[-1, 0] == len(children) - 1
    assert live == {0: len(children) - 1}
    return used


@pytest.mark.parametrize("n", [2, 3, 5, 16, 100, 2048])
@pytest.mark.parametrize("shape", ["random", "caterpillar", "balanced"])
def test_plain_plan_is_a_valid_post_order(n, shape):
    if shape == "random":
        children = random_children(np.random.default_rng(n), n, 2)
    else:
        children = (_caterpillar if shape == "caterpillar" else _balanced)(n)[None]
    plan = tree_plan_plain(torch.as_tensor(children)).numpy()
    assert plan.shape == (*children.shape[:2], 4) and plan.dtype == np.int32
    used = [_walk(ch, p) for ch, p in zip(children, plan)]
    assert max(used) <= slots_for(n) <= int(np.log2(n))
    if shape == "caterpillar":
        assert used == [1]
    if shape == "balanced" and n & (n - 1) == 0:
        assert used == [slots_for(n)]  # the bound is tight


def test_larger_need_first_and_the_first_child_on_a_tie():
    # 7 leaves; nodes 7..12 are ancestors 0..5. The root 12 = (8, 11):
    # 8 = (2, 3) needs 1 slot, 11 = (9, 10) needs 2, so 11 goes first.
    # 11's children 9 = (4, 5) and 10 = (6, 7) tie at 1: 9 first. 10's
    # ancestor child 7 = (0, 1) goes before its leaf 6.
    children = np.array([[(0, 1), (2, 3), (4, 5), (6, 7), (9, 10), (8, 11)]], np.int32)
    plan = tree_plan_plain(torch.as_tensor(children)).numpy()[0]
    assert plan.tolist() == [
        [2, 4, 5, 0], [0, 0, 1, 1], [3, 6, ~1, 1], [4, ~0, ~1, 0], [1, 2, 3, 1],
        [5, ~1, ~0, 0],
    ]


def test_cpu_wrapper_runs_plain_and_counts_no_launch():
    children = torch.as_tensor(random_children(np.random.default_rng(1), 30, 3))
    before = tree_plan.launches
    assert torch.equal(tree_plan(children), tree_plan_plain(children))
    assert tree_plan.launches == before


def test_wrapper_rejects_what_the_kernel_does_not_take():
    children = torch.as_tensor(random_children(np.random.default_rng(2), 6, 2))
    with pytest.raises(TypeError):
        tree_plan(children.long())
    with pytest.raises(ValueError):
        tree_plan(children[..., :1])
    with pytest.raises(ValueError):
        slots_for(1)


def test_wrapper_has_no_fallback_around_the_launch():
    tree = ast.parse(inspect.getsource(tree_plan_module))
    assert not any(isinstance(node, ast.Try) for node in ast.walk(tree))
    source = inspect.getsource(tree_plan)
    launch = source.index("trex_tree_plan(")
    assert source.rindex("tree_plan_plain(") < launch
    assert 'device.type == "cpu"' in source[: source.index("tree_plan_plain(")]


def test_plan_launch_stages_trees_that_fit():
    # 12 bytes an ancestor, 4 trees a block while they fit an H100's block.
    assert plan_launch(511, 232448) == PlanLaunch(4, True, 4 * 6144)
    assert plan_launch(2047, 232448) == PlanLaunch(4, True, 4 * 24576)
    assert plan_launch(10_000, 232448) == PlanLaunch(1, True, 120000)
    assert plan_launch(20_000, 232448) == PlanLaunch(4, False, 0)


def test_slot_plan_modes():
    # The widest block that keeps the most threads an SM.
    assert slot_plan(6, 96, 64, 232448) == SlotPlan("shared", 6, 128, 12352, 2048)
    # Several threads a site: the block's threads stay within max_threads.
    plan = slot_plan(6, 1480, 31744, 232448, threads_per_site=4, max_threads=512)
    assert plan == SlotPlan("shared", 6, 128, 221184, 512, 4)
    # Shared slots wherever a width fits, however few threads an SM holds.
    assert slot_plan(6, 7000, 4096, 232448).sites_per_block == 32
    # Nothing fits: the global mode where the kernel has one, else an error.
    plan = slot_plan(11, 8000, 4096, 232448, global_column_bytes=64)
    assert (plan.mode, plan.sites_per_block, plan.smem_bytes) == ("global", 128, 12288)
    with pytest.raises(ValueError, match="do not fit"):
        slot_plan(11, 8000, 4096, 232448)
