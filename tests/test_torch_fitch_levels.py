"""K6, the level-synchronous Fitch scorer, on the CPU: its plain version
against the JAX experiment kernel (`benchmarks/fitch_levels.py`, interpret
mode) and against K1's plain version on the same balanced topology; a
bit-sliced twin of the kernel's merge against both; its topology, its
domain and its launch plan.

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

from trex_tpu_torch.ops.fitch_cuda import batched_fitch_score_plain, pack_planes, planes_for
from trex_tpu_torch.ops.fitch_levels import (
    LevelsPlan,
    balanced_topology_levels,
    fitch_levels_balanced,
    fitch_levels_plain,
    launch_plan,
    plan_for_width,
    shared_bytes,
    sliced_plan,
    sliced_shared_bytes,
    sites_plan,
    split_scratch_words,
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


def _sliced_twin(masks: torch.Tensor, n_leaves: int, batch: int, planes: int, parts: int):
    """The bit-sliced kernel's arithmetic in plain torch: the masks packed
    into ``planes`` planes in the kernel's word layout (K1's
    ``pack_planes``), each merge of 32 sites o = OR_q (a_q & b_q), new_q =
    (a_q & b_q) | (~o & (a_q | b_q)), events += popcount(~o); each of
    ``parts`` subtrees merged to its root, then the levels above (the
    split)."""
    full = 0xFFFFFFFF

    def merge_levels(rows):  # (nodes, words, planes) -> root, events
        events = 0
        while rows.shape[0] > 1:
            a, b = rows[0::2], rows[1::2]
            o = torch.zeros(a.shape[:-1], dtype=torch.int64)
            for q in range(planes):
                o |= a[..., q] & b[..., q]
            e = ~o & full
            rows = (a & b) | (e[..., None] & (a | b))
            events += int(((e[..., None] >> torch.arange(32)) & 1).sum())
        return rows, events

    rows = pack_planes(masks, planes)
    n_part = n_leaves // parts
    merged = [merge_levels(rows[k * n_part:(k + 1) * n_part]) for k in range(parts)]
    _, top = merge_levels(torch.cat([root for root, _ in merged]))
    return torch.full((batch,), float(top + sum(events for _, events in merged)))


@pytest.mark.parametrize("n_states", [1, 4, 6, 8, 32])
@pytest.mark.parametrize("n_leaves", [2, 8, 64])
def test_sliced_twin(n_leaves, n_states):
    # Against the plain version and the JAX kernel in interpret mode, with
    # zero masks; at 32 states (the one-site-per-word mode) with bit 31 in
    # 32 planes. The split is the bit-sliced plan's at B = 1 (32 parts at 64
    # leaves).
    rng = np.random.default_rng(10 * n_leaves + n_states)
    masks = _masks(rng, n_leaves, 128, n_states=n_states, bit31=0.05 if n_states == 32 else 0)
    masks[rng.random(masks.shape) < 0.05] = 0
    assert (masks == 0).any() and ((masks < 0).any() == (n_states == 32))
    planes = planes_for(n_states) or 32
    parts = sliced_plan(1, n_leaves, 128, planes, **H100).parts if planes < 32 else 1
    assert parts == (1 if n_states == 32 else max(1, n_leaves // 2))
    got = _sliced_twin(torch.as_tensor(masks), n_leaves, 2, planes, parts)
    assert torch.equal(got, fitch_levels_plain(torch.as_tensor(masks), n_leaves, 2))
    ref = jax_levels.fitch_levels_balanced(
        jnp.asarray(masks), n_leaves=n_leaves, batch=2, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_n_states_domain():
    masks = torch.ones((8, 128), dtype=torch.int32)
    for bad in (0, 33, -1):
        with pytest.raises(ValueError, match="n_states"):
            fitch_levels_balanced(masks, n_leaves=8, batch=2, n_states=bad)
    # On a CPU tensor the alphabet picks nothing: the plain version runs.
    for q in (1, 4, 8, 9, 32):
        assert fitch_levels_balanced(
            masks, n_leaves=8, batch=2, n_states=q).tolist() == [0.0, 0.0]
    # With many trees it picks the mode: 4 planes up to 4 states, 8 up to
    # 8, then one site per word.
    assert [launch_plan(2048, 8, 128, q, **H100).planes for q in (1, 4, 5, 8, 9, 31, 32)] == [
        4, 4, 8, 8, 0, 0, 0]


@pytest.mark.parametrize("shape, plan", [
    # The one-site-per-word mode (an alphabet of 32 states) at the A/B's
    # shapes: (a) the JAX A/B's own, (b) the main path's rescoring size,
    # (c) the NNI route's size, (d) 20 states; and 2048 leaves, whose rows
    # do not fit in shared memory: (batch, n_leaves, L, n_states).
    ((2048, 64, 1024, 32), LevelsPlan(0, 256, 6, True, 4, 99, 21, 66560)),
    ((1024, 64, 1024, 32), LevelsPlan(0, 256, 6, True, 4, 99, 11, 66560)),
    ((1, 512, 2048, 32), LevelsPlan(0, 32, 6, True, 64, 1, 1, 67456, lanes=8)),
    ((256, 128, 1024, 32), LevelsPlan(0, 256, 6, True, 4, 33, 8, 134144)),
    ((512, 64, 1024, 32), LevelsPlan(0, 256, 6, True, 4, 99, 6, 66560)),
    ((1, 2048, 2048, 32), LevelsPlan(0, 32, 6, False, 64, 1, 1, 8064, lanes=8)),
])
def test_launch_plan(shape, plan):
    batch, n_leaves, length, _ = shape
    got = launch_plan(*shape, **H100)
    assert got == plan and got.mode == "one site per word"
    assert got.shared_bytes == shared_bytes(n_leaves, got.width, got.depth, got.staged)
    assert got.shared_bytes <= H100["smem_optin"]
    assert got.chunks * got.width == length
    assert got.tree_groups * got.rounds >= batch
    assert got.lanes == 256 // got.width and got.slots == got.parts == 1
    # The node lanes share the level regions evenly; with many trees, the
    # widest blocks, one node lane merging the whole tree in registers.
    assert n_leaves >> got.depth >= min(n_leaves, 256 // got.width)
    assert (got.width == 256) == (batch * length // 256 >= 2 * H100["n_sms"])
    assert got == plan_for_width(*shape[:3], got.width, **H100)
    assert split_scratch_words(got) == 0


@pytest.mark.parametrize("shape, plan", [
    # The bit-sliced mode at chip_smoke's K6 shapes (a) 64 x 1024, B =
    # 2048, (a1024), (c) 128 x 1024, B = 256, and (f) (a) at 6 states:
    # blocks of 512 threads on 128 sites, the fewest node lanes a tree
    # whose blocks reach 7/8 of the SMs (128 blocks).
    ((2048, 64, 1024, 4), LevelsPlan(4, 4, 6, True, 8, 16, 1, 46080, slots=128)),
    ((1024, 64, 1024, 4), LevelsPlan(4, 4, 5, True, 8, 16, 1, 50176, slots=64, lanes=2)),
    ((256, 128, 1024, 4), LevelsPlan(4, 4, 4, True, 8, 16, 1, 57344, slots=16, lanes=8)),
    ((2048, 64, 1024, 6), LevelsPlan(8, 4, 5, True, 8, 16, 1, 91136, slots=128)),
    # Few trees, on either side of the choice between the bit-sliced split
    # and one site per word. (b) 512 x 2048 at B = 1: 64 blocks of staged
    # rows, one site per word. (e) 2048 x 2048 at B = 1: its rows do not
    # fit staged, and 64 blocks are under one an SM, so each tree is split
    # over 32 blocks of 256 threads by subtree (512 blocks), node lanes of
    # 8 leaves. (e) at B = 3 (192 blocks reading global memory) and (b) at
    # B = 8 (448 blocks of staged rows) cross back.
    ((1, 512, 2048, 4), LevelsPlan(0, 32, 6, True, 64, 1, 1, 67456, lanes=8)),
    ((1, 2048, 2048, 4), LevelsPlan(4, 4, 3, True, 16, 1, 1, 38848, lanes=8, parts=32)),
    ((3, 2048, 2048, 4), LevelsPlan(0, 32, 6, False, 64, 3, 1, 8064, lanes=8)),
    ((8, 512, 2048, 4), LevelsPlan(4, 4, 3, True, 16, 8, 1, 43968, lanes=16, parts=4)),
    # Few trees of two leaves: no split can help (n / 2 parts at most).
    ((3, 2, 128, 1), LevelsPlan(4, 4, 1, True, 1, 1, 1, 1376, slots=3)),
    # 70,000 trees: one wave of tree groups, the rest in rounds.
    ((70000, 64, 128, 4), LevelsPlan(4, 4, 6, True, 1, 528, 2, 46080, slots=128)),
])
def test_launch_plan_sliced(shape, plan):
    batch, n_leaves, length, n_states = shape
    got = launch_plan(*shape, **H100)
    assert got == plan
    sliced = sliced_plan(*shape[:3], planes_for(n_states), **H100)
    assert sliced.mode == f"{planes_for(n_states)} planes"
    assert sliced.shared_bytes == sliced_shared_bytes(
        n_leaves, sliced.planes, sliced.depth, sliced.slots, sliced.parts)
    assert sliced.shared_bytes <= H100["smem_optin"]
    assert sliced.chunks * 128 == length
    assert sliced.slots * sliced.lanes * 4 <= sliced.threads <= 512
    assert sliced.tree_groups * sliced.slots * sliced.rounds >= batch
    assert n_leaves // sliced.parts >> sliced.depth >= 1
    # The split: one tree a block, in one round, 256 threads, and a ticket
    # and a root row of 4 x planes words per (chunk, part) in the scratch.
    few = batch * sliced.chunks < 2 * H100["n_sms"]
    assert (sliced.parts > 1) == (few and n_leaves > 2)
    if sliced.parts > 1:
        assert sliced.slots == sliced.rounds == 1 and sliced.blocks >= 2 * H100["n_sms"]
        assert sliced.threads == 256
        tickets = batch * sliced.chunks
        assert split_scratch_words(sliced) == (
            -(-tickets // 4) * 4 + tickets * sliced.parts * 4 * sliced.planes)
    # Where it splits, one site per word instead where that grid has at
    # most two blocks an SM with staged rows, or more than one an SM that
    # reads its rows from global memory.
    sites = sites_plan(*shape[:3], **H100)
    takes_sites = sliced.parts > 1 and few and (
        sites.blocks <= 2 * H100["n_sms"] if sites.staged else sites.blocks > H100["n_sms"])
    assert got == (sites if takes_sites else sliced)
    assert got.mode == ("one site per word" if takes_sites else sliced.mode)


def test_launch_plan_limits():
    # One site per word, with one tree the narrowest blocks (the most of
    # them); the level regions alone must fit: 32,768 leaves do, 65,536
    # do not.
    assert launch_plan(1, 32768, 128, 32, **H100) == LevelsPlan(
        0, 32, 6, False, 4, 1, 1, 130944, lanes=8)
    with pytest.raises(ValueError, match="do not fit"):
        launch_plan(1, 65536, 128, 32, **H100)
    assert plan_for_width(1, 32768, 128, 64, **H100) is None
    assert plan_for_width(4, 64, 384, 256, **H100) is None  # 256 does not divide 384
    # Bit-sliced, the split keeps each part's rows staged: 65,536 leaves
    # in 512 parts of 128 at 8 planes.
    assert launch_plan(1, 65536, 128, 8, **H100) == LevelsPlan(
        8, 4, 3, True, 1, 1, 1, 164736, lanes=16, parts=512)
    # A split's node lanes fill at most its 256 threads: 2^20 leaves in
    # 512 parts of 2048, 64 lanes of 32 leaves.
    assert sliced_plan(1, 1 << 20, 128, 4, **H100) == LevelsPlan(
        4, 4, 5, True, 1, 1, 1, 172992, lanes=64, parts=512)
    with pytest.raises(ValueError, match="at most 32 states"):
        launch_plan(1, 64, 128, 33, **H100)
