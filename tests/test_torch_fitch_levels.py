"""K6, the level-synchronous Fitch scorer, on the CPU: its plain version
against the JAX experiment kernel (`benchmarks/fitch_levels.py`, interpret
mode) and against K1's plain version on the same balanced topology; its
topology, its domain and its launch plan.

The CUDA kernel itself runs only on the card (``chip_smoke.py`` and
``tools/fitch_levels_ab.py`` hold it bit for bit against the plain version
and against K1 at every shape pinned here).
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _torch_parity  # noqa: F401  (one PyTorch thread per worker)

from trex_tpu_torch.ops.fitch_cuda import batched_fitch_score_plain
from trex_tpu_torch.ops.fitch_levels import (
    LevelsPlan,
    balanced_topology_levels,
    fitch_levels_balanced,
    fitch_levels_plain,
    launch_plan,
    plan_for_width,
    shared_bytes,
)

_SPEC = importlib.util.spec_from_file_location(
    "fitch_levels",
    os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "benchmarks",
        "fitch_levels.py",
    ),
)
jax_levels = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(jax_levels)

H100 = dict(n_sms=132, smem_optin=232448)


def _masks(rng, n_leaves, length, n_states=4, ambiguous=0.2, bit31=0.05):
    """int32 masks: single states, a share of them random non-empty
    subsets, and a share with bit 31 (the int32 sign bit) set too."""
    masks = np.left_shift(np.int64(1), rng.integers(0, n_states, (n_leaves, length)))
    amb = rng.random((n_leaves, length)) < ambiguous
    masks[amb] = rng.integers(1, 1 << n_states, int(amb.sum()), dtype=np.int64)
    masks[rng.random((n_leaves, length)) < bit31] |= 1 << 31
    return (masks - ((masks >> 31) << 32)).astype(np.int32)


@pytest.mark.parametrize("n_leaves", [8, 32])
def test_plain_matches_jax_interpret(n_leaves):
    rng = np.random.default_rng(n_leaves)
    masks = _masks(rng, n_leaves, 256)
    assert (masks < 0).any()
    ref = jax_levels.fitch_levels_balanced(
        jnp.asarray(masks), n_leaves=n_leaves, batch=4, interpret=True)
    got = fitch_levels_plain(torch.as_tensor(masks), n_leaves, 4)
    assert got.dtype == torch.float32 and got.shape == (4,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # On a CPU tensor the wrapper is the plain version, and launches nothing.
    before = fitch_levels_balanced.launches
    assert torch.equal(
        fitch_levels_balanced(torch.as_tensor(masks), n_leaves=n_leaves, batch=4), got)
    assert fitch_levels_balanced.launches == before


@pytest.mark.parametrize("n_leaves", [2, 16, 64])
def test_topology_matches_jax(n_leaves):
    ours = balanced_topology_levels(n_leaves, device="cpu")
    ref = jax_levels.balanced_topology_levels(n_leaves)
    assert ours.children.dtype == torch.int32 and ours.parents.dtype == torch.int32
    np.testing.assert_array_equal(ours.children.numpy(), np.asarray(ref.children))
    np.testing.assert_array_equal(ours.parents.numpy(), np.asarray(ref.parents))


@pytest.mark.parametrize("n_leaves", [16, 64])
def test_plain_matches_k1_plain(n_leaves):
    # The same function as K1 on the balanced level-order topology.
    rng = np.random.default_rng(100 + n_leaves)
    masks = torch.as_tensor(_masks(rng, n_leaves, 384, n_states=20))
    children = balanced_topology_levels(n_leaves, device="cpu").children
    k1 = batched_fitch_score_plain(
        children[None].expand(3, -1, -1), masks, torch.ones(384))
    assert torch.equal(fitch_levels_plain(masks, n_leaves, 3), k1)


def test_domain():
    masks = torch.ones((8, 256), dtype=torch.int32)
    for n in (1, 6, 12):
        with pytest.raises(ValueError, match="power of two"):
            balanced_topology_levels(n, device="cpu")
    for length in (100, 4096, 0):
        with pytest.raises(ValueError, match="multiple of 128"):
            fitch_levels_balanced(torch.ones((8, length), dtype=torch.int32), n_leaves=8, batch=2)
    with pytest.raises(ValueError, match="power of two"):
        fitch_levels_balanced(torch.ones((12, 256), dtype=torch.int32), n_leaves=12, batch=2)
    with pytest.raises(ValueError, match=r"\(16, L\)"):
        fitch_levels_balanced(masks, n_leaves=16, batch=2)
    with pytest.raises(ValueError, match="batch"):
        fitch_levels_balanced(masks, n_leaves=8, batch=0)
    with pytest.raises(TypeError, match="int32"):
        fitch_levels_balanced(masks.long(), n_leaves=8, batch=2)
    # L = 384 (3 x 128) is inside the domain, as it is for the JAX function.
    assert fitch_levels_balanced(
        torch.ones((8, 384), dtype=torch.int32), n_leaves=8, batch=2).tolist() == [0.0, 0.0]


@pytest.mark.parametrize("shape, plan", [
    # The A/B's shapes: (a) the JAX A/B's own, (b) the main path's
    # rescoring size, (c) the NNI route's size, (d) 20 states; and 2048
    # leaves, whose rows do not fit in shared memory: (batch, n_leaves, L).
    ((2048, 64, 1024), LevelsPlan(256, 6, True, 4, 99, 21, 66560)),
    ((1024, 64, 1024), LevelsPlan(256, 6, True, 4, 99, 11, 66560)),
    ((1, 512, 2048), LevelsPlan(32, 6, True, 64, 1, 1, 67456)),
    ((256, 128, 1024), LevelsPlan(256, 6, True, 4, 33, 8, 134144)),
    ((512, 64, 1024), LevelsPlan(256, 6, True, 4, 99, 6, 66560)),
    ((1, 2048, 2048), LevelsPlan(32, 6, False, 64, 1, 1, 8064)),
])
def test_launch_plan(shape, plan):
    batch, n_leaves, length = shape
    got = launch_plan(*shape, **H100)
    assert got == plan
    assert got.shared_bytes == shared_bytes(n_leaves, got.width, got.depth, got.staged)
    assert got.shared_bytes <= H100["smem_optin"]
    assert got.chunks * got.width == length
    assert got.tree_groups * got.rounds >= batch
    # The node lanes share the level regions evenly; with many trees, the
    # widest blocks, one node lane merging the whole tree in registers.
    assert n_leaves >> got.depth >= min(n_leaves, 256 // got.width)
    assert (got.width == 256) == (batch * length // 256 >= 2 * H100["n_sms"])
    assert got == plan_for_width(*shape, got.width, **H100)


def test_launch_plan_limits():
    # With one tree the narrowest blocks (the most of them); the level
    # regions alone must fit: 32,768 leaves do, 65,536 do not.
    assert launch_plan(1, 32768, 128, **H100) == LevelsPlan(32, 6, False, 4, 1, 1, 130944)
    with pytest.raises(ValueError, match="do not fit"):
        launch_plan(1, 65536, 128, **H100)
    assert plan_for_width(1, 32768, 128, 64, **H100) is None
    assert plan_for_width(4, 64, 384, 256, **H100) is None  # 256 does not divide 384
