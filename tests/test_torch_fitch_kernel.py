"""K1's bit-sliced redesign on the CPU: its launch plan, its leaf-plane
layout, a model of its arithmetic, and its plain version against the JAX
Pallas kernel above 4 states; and the dispatch's one-off Hamming test and
alphabet contract.

The CUDA kernel itself runs only on the card (``chip_smoke.py`` holds it
bit for bit against the plain version at every shape pinned here); these
tests pin what the card run depends on and the CPU can reach.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import integer_weights, parents_of, random_children

from trex_tpu.ops.sankoff_pallas import batched_fitch_score_pallas
from trex_tpu.topology import Topology as JaxTopology
from trex_tpu_torch.ops.dispatch import batched_scores_fastest, check_alphabet
from trex_tpu_torch.ops.fitch_cuda import (
    LaunchPlan,
    batched_fitch_score_plain,
    global_scratch_words,
    launch_plan,
    n_words,
    pack_planes,
    planes_for,
    scratch_words,
    unpack_planes,
)
from trex_tpu_torch.ops.sankoff_cuda import is_hamming
from trex_tpu_torch.topology import from_numpy
from trex_tpu_torch.types import CostModel

H100 = dict(n_sms=132, smem_optin=232448)


def _masks(rng, n_leaves, length, n_states, ambiguous=0.05):
    """int32 masks of single states, a share of them random subsets; at 32
    states bit 31 (the int32 sign bit) is set too."""
    masks = np.left_shift(np.int64(1), rng.integers(0, n_states, (n_leaves, length)))
    amb = rng.random((n_leaves, length)) < ambiguous
    masks[amb] = rng.integers(1, 1 << n_states, int(amb.sum()), dtype=np.int64)
    return (masks - ((masks >> 31) << 32)).astype(np.int32)


@pytest.mark.parametrize("shape, plan", [
    # (a) bench.py's headline, (b) the main path's rescoring, (c) the NNI
    # route's batch, (d) 20 states, (e) 32 states, (f) a big table, (g) a
    # long alignment, (h) 6 states in 8 planes: (batch, n_taxa, length,
    # n_states).
    ((2048, 64, 1024, 4), LaunchPlan(4, 16, 12, 3, 2, 57, 224080)),
    ((1, 512, 2048, 4), LaunchPlan(4, 1, 1, 1, 64, 1, 20608)),
    ((252, 128, 1024, 4), LaunchPlan(4, 8, 11, 1, 4, 23, 207424)),
    ((512, 64, 1024, 20), LaunchPlan(0, 128, 2, 8, 8, 32, 99824)),
    ((64, 64, 1024, 32), LaunchPlan(0, 128, 2, 1, 8, 32, 98816)),
    ((4, 2048, 1024, 4), LaunchPlan(4, 1, 4, 1, 32, 1, 229424)),
    ((256, 64, 8192, 4), LaunchPlan(4, 16, 12, 3, 16, 8, 224080)),
    ((2048, 64, 1024, 6), LaunchPlan(8, 8, 12, 6, 4, 29, 223056)),
])
def test_launch_plan(shape, plan):
    got = launch_plan(*shape, **H100)
    assert got == plan
    assert got.shared_bytes <= H100["smem_optin"]
    assert got.slots * got.width <= 256
    assert got.chunks * got.width >= (n_words(shape[2]) if got.planes else shape[2])
    assert got.tree_groups * got.rounds * got.slots >= shape[0]


def test_launch_plan_modes_and_taxa_limit():
    # Bit-sliced rows up to 8 states, one site per word above (measured
    # faster there) and where 8-plane rows do not fit.
    assert [planes_for(q) for q in (1, 4, 5, 8, 9, 32)] == [4, 4, 8, 8, 0, 0]
    assert launch_plan(1, 3000, 1024, 8, **H100).planes == 8
    assert launch_plan(1, 3300, 1024, 8, **H100).planes == 0
    # Up to 5811 taxa one tree's rows of a 4-site block fit in shared
    # memory (the old per-site kernel's limit was 3632); above, the global
    # mode reads and writes them in global memory, 32 sites a block.
    for q in (4, 20):
        staged = launch_plan(1, 5811, 1024, q, **H100)
        assert staged == LaunchPlan(0, 4, 1, 1, 256, 1, 232448)
        assert staged.staged and staged.shared_bytes <= H100["smem_optin"]
        for n in (5812, 6000, 10_000):
            plan = launch_plan(1, n, 1024, q, **H100)
            assert plan == LaunchPlan(0, 32, 1, 1, 32, 1, 0, staged=False)
            assert plan.shared_bytes <= H100["smem_optin"]
    # chip_smoke's shape (i): four 8192-taxon trees in flight at once.
    wide = launch_plan(4, 8192, 1024, 4, **H100)
    assert wide == LaunchPlan(0, 32, 1, 1, 32, 4, 0, staged=False)
    assert global_scratch_words(wide, 8192, 1024) == 4 * 8191 * 1024
    # A tree group per GLOBAL_SCRATCH_BYTES of ancestor rows; the rest in rounds.
    many = launch_plan(100, 8192, 1024, 4, **H100)
    assert (many.tree_groups, many.rounds, many.width) == (8, 13, 32)
    with pytest.raises(ValueError, match="at most 32 states"):
        planes_for(33)


def test_scratch_words_per_call():
    """Each call's own scratch: the leaves' packed planes in the bit-sliced
    mode, the ancestor rows in the global mode, none in the staged one-
    site-per-word mode."""
    sliced = launch_plan(1, 512, 2048, 4, **H100)
    assert sliced.planes == 4
    assert scratch_words(sliced, 512, 2048) == 512 * 4 * n_words(2048)
    wide = launch_plan(4, 8192, 1024, 4, **H100)
    assert scratch_words(wide, 8192, 1024) == global_scratch_words(wide, 8192, 1024)
    per_site = launch_plan(64, 64, 1024, 20, **H100)
    assert per_site.planes == 0 and per_site.staged
    assert scratch_words(per_site, 64, 1024) == 0


@pytest.mark.parametrize("n_states", [4, 8, 20, 32])
def test_pack_planes_round_trips(n_states):
    # The kernel's 4 and 8 planes, and the same layout at 20 and 32.
    rng = np.random.default_rng(n_states)
    masks = torch.as_tensor(_masks(rng, 5, 300, n_states, ambiguous=0.3))
    planes = pack_planes(masks, n_states)
    assert planes.shape == (5, n_words(300), n_states)
    assert torch.equal(unpack_planes(planes, 300), masks)
    # Word 5 holds sites 128 + 4 i + 1; bit 7 of its plane 2 is site 157's bit 2.
    assert int(planes[3, 5, 2] >> 7 & 1) == int(masks[3, 157]) >> 2 & 1


def _kernel_model(children, masks, weights, n_states):
    """The kernel's bit-sliced arithmetic in torch: planes as staged, the
    3-plane low counter added into the high one every 6 steps, per-site
    counts expanded and weighted at the sites the words hold."""
    planes = pack_planes(torch.as_tensor(masks), planes_for(n_states))  # (n, words, Q)
    n_leaves, words, _ = planes.shape
    n_anc = n_leaves - 1
    kplanes = max(3, n_anc.bit_length())
    full = (1 << 32) - 1
    site = (128 * (torch.arange(words)[:, None] // 4) + 4 * torch.arange(32)[None, :]
            + torch.arange(words)[:, None] % 4)
    w = torch.zeros((words, 32), dtype=torch.float32)
    live = site < masks.shape[1]
    w[live] = torch.as_tensor(weights)[site[live]]
    scores = []
    for tree in children:
        rows = list(planes)
        low = [torch.zeros(words, dtype=torch.int64) for _ in range(3)]
        high = [torch.zeros(words, dtype=torch.int64) for _ in range(kplanes)]

        def flush():
            carry = torch.zeros(words, dtype=torch.int64)
            for i in range(kplanes):
                add = low[i] if i < 3 else torch.zeros_like(carry)
                high[i], carry = high[i] ^ add ^ carry, (high[i] & add) | (carry & (high[i] ^ add))
            for lo in low:
                lo.zero_()

        for a, (x, y) in enumerate(tree.tolist()):
            A, B = rows[x], rows[y]
            inter = A & B
            o = torch.zeros(words, dtype=torch.int64)
            for q in range(inter.shape[-1]):
                o |= inter[:, q]
            e = ~o & full
            rows.append(inter | (e[:, None] & (A | B)))
            t = low[0] & e
            low[2] ^= low[1] & t
            low[1] ^= t
            low[0] ^= e
            if (a + 1) % 6 == 0:
                flush()
        flush()
        bits = torch.arange(32)
        count = sum(((high[i][:, None] >> bits) & 1) << i for i in range(kplanes))
        scores.append(float((count.to(torch.float32) * w).sum()))
    return torch.tensor(scores, dtype=torch.float32)


@pytest.mark.parametrize("n_states, n_leaves, length", [(4, 30, 200), (6, 9, 130), (8, 12, 70)])
def test_kernel_arithmetic_matches_plain(n_states, n_leaves, length):
    # The kernel's two bit-sliced instantiations: 4 planes, and 8 (two
    # groups of 4) at 6 and 8 states. 29 ancestors: four flushes of the low
    # counter and a remainder.
    rng = np.random.default_rng(n_states)
    children = random_children(rng, n_leaves, 3)
    masks = _masks(rng, n_leaves, length, n_states, ambiguous=0.2)
    weights = integer_weights(rng, length)
    plain = batched_fitch_score_plain(
        torch.as_tensor(children), torch.as_tensor(masks), torch.as_tensor(weights))
    assert torch.equal(_kernel_model(children, masks, weights, n_states), plain)


@pytest.mark.parametrize("n_states", [20, 32])
def test_plain_matches_pallas_interpret_wide_alphabets(n_states):
    rng = np.random.default_rng(100 + n_states)
    children = random_children(rng, 7, 3)
    masks = _masks(rng, 7, 150, n_states, ambiguous=0.2)
    weights = integer_weights(rng, 150)
    plain = batched_fitch_score_plain(
        torch.as_tensor(children), torch.as_tensor(masks), torch.as_tensor(weights))
    topo = JaxTopology(children=jnp.asarray(children), parents=jnp.asarray(parents_of(children)))
    ref = batched_fitch_score_pallas(
        topo, jnp.asarray(masks), site_weights=jnp.asarray(weights),
        sequences_are_masks=True, n_states=n_states, interpret=True,
    )
    np.testing.assert_array_equal(plain.numpy(), np.asarray(ref))


def test_dispatch_tests_a_cost_for_hamming_once(monkeypatch):
    # batched_scores_fastest copies a cost matrix to the host once, not on
    # every call; an edited cost (a new version) is tested again.
    rng = np.random.default_rng(9)
    children = random_children(rng, 6, 5)
    topos = from_numpy(children, parents_of(children))
    leaves = torch.as_tensor(rng.integers(0, 4, (6, 40)).astype(np.int32))
    cost = CostModel.hamming(4).matrix
    copies = []
    to_host = torch.Tensor.cpu

    def counted(self, *args, **kwargs):
        copies.append(tuple(self.shape))
        return to_host(self, *args, **kwargs)

    monkeypatch.setattr(torch.Tensor, "cpu", counted)
    scores = [batched_scores_fastest(topos, cost, leaves) for _ in range(3)]
    assert copies.count((4, 4)) == 1
    assert all(torch.equal(s, scores[0]) for s in scores)
    cost[0, 1] = 2.0
    assert not is_hamming(cost)
    assert copies.count((4, 4)) == 2


@pytest.mark.parametrize("sequences_are_masks", [False, True])
def test_check_alphabet_refuses_bits_above_the_cost(sequences_are_masks):
    # K1 reads Q bits of each mask; a state (or mask bit) at or above Q
    # would score differently from the plain version, so the climbs and
    # bench refuse it once, before scoring.
    rng = np.random.default_rng(11)
    states = rng.integers(0, 4, (6, 40)).astype(np.int32)
    leaves = np.left_shift(1, states).astype(np.int32) if sequences_are_masks else states
    hamming4 = CostModel.hamming(4).matrix
    check_alphabet(hamming4, torch.as_tensor(leaves), sequences_are_masks=sequences_are_masks)
    outside = leaves.copy()
    outside[2, 7] = 16 if sequences_are_masks else 4  # a gap coded as state 4
    with pytest.raises(ValueError, match="at or above 4"):
        check_alphabet(hamming4, torch.as_tensor(outside),
                       sequences_are_masks=sequences_are_masks)
    # Costs that go to K5, and 32-state masks, are not held to it.
    check_alphabet(CostModel.transition_transversion(1, 2).matrix, torch.as_tensor(outside),
                   sequences_are_masks=sequences_are_masks)
    check_alphabet(CostModel.hamming(32).matrix, torch.as_tensor(outside),
                   sequences_are_masks=sequences_are_masks)
