"""Parity of the insertion-delta plain version (K2's twin) with the Pallas
kernel of trex_tpu, run in interpret mode on the CPU.

130 sites: not a multiple of the Pallas site block, so its padding path is
exercised. Inputs include pass-through rows (the pruned node's parent).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import integer_weights, random_children, random_masks

from trex_tpu.ops.insertion_pallas import insertion_delta_pallas
from trex_tpu_torch.ops.insertion_cuda import (
    LaunchPlan,
    insertion_delta_cuda,
    insertion_delta_plain,
    launch_plan,
)
from trex_tpu_torch.ops.spr_scan import _up_pass
from trex_tpu_torch.search import stepwise

N_LEAVES, LENGTH = 10, 130


def _pallas(var, up, t, weights):
    return np.asarray(
        insertion_delta_pallas(
            jnp.asarray(var), jnp.asarray(up), jnp.int32(t), jnp.asarray(weights),
            n_leaves=N_LEAVES, interpret=True,
        )
    )


def _random_variant(seed):
    """A random tree with leaf t pruned: t's parent row becomes (s, s)."""
    rng = np.random.default_rng(seed)
    children = random_children(rng, N_LEAVES, 1)[0]
    masks = random_masks(rng, N_LEAVES, LENGTH)
    t = int(rng.integers(N_LEAVES))
    row = int(np.nonzero((children == t).any(axis=1))[0][0])
    sibling = int(children[row].sum() - t)
    var = children.copy()
    var[row] = (sibling, sibling)
    up, _ = _up_pass(torch.as_tensor(var)[None], torch.as_tensor(masks))
    return var, up[0].numpy(), t, integer_weights(rng, LENGTH)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_matches_pallas_on_pruned_variants(seed):
    var, up, t, weights = _random_variant(seed)
    assert (var[:, 0] == var[:, 1]).sum() == 1  # one pass-through row
    ours = insertion_delta_plain(
        torch.as_tensor(var), torch.as_tensor(up), t, torch.as_tensor(weights)
    )
    np.testing.assert_array_equal(ours.numpy(), _pallas(var, up, t, weights))


@pytest.mark.parametrize("k", [3, 6, 9])
def test_plain_matches_pallas_on_stepwise_states(k):
    """Inputs in the slot-shift layout of a real stepwise construction,
    including stale chain rows above the frontier. The port hands over the
    flagged up table; the Pallas kernel takes the masked one."""
    rng = np.random.default_rng(10 + k)
    masks = random_masks(rng, N_LEAVES, LENGTH)
    order = [int(x) for x in rng.permutation(N_LEAVES)]
    st = stepwise._seed_state(
        masks, order, 15, integer_weights(rng, LENGTH), torch.device("cpu")
    )
    for step in range(3, k):
        stepwise._insert(st, step)
    var, up_states, t = stepwise._insertion_inputs(st, k)
    ours = insertion_delta_plain(var, up_states, t, st.weights)
    masked = up_states & stepwise._SMASK
    ref = _pallas(var.numpy(), masked.numpy(), t, st.weights.numpy())
    np.testing.assert_array_equal(ours.numpy(), ref)


def test_plain_masks_the_event_flag():
    """The flagged and the masked table give the same delta."""
    rng = np.random.default_rng(21)
    masks = random_masks(rng, N_LEAVES, LENGTH)
    order = [int(x) for x in rng.permutation(N_LEAVES)]
    st = stepwise._seed_state(
        masks, order, 15, integer_weights(rng, LENGTH), torch.device("cpu")
    )
    for step in range(3, 7):
        stepwise._insert(st, step)
    var, up_states, t = stepwise._insertion_inputs(st, 7)
    assert bool((up_states >> 30).any())  # some internal rows carry the flag
    flagged = insertion_delta_plain(var, up_states, t, st.weights)
    masked = insertion_delta_plain(var, up_states & stepwise._SMASK, t, st.weights)
    np.testing.assert_array_equal(flagged.numpy(), masked.numpy())


H100_OPTIN = 232_448  # an H100's opt-in shared memory per block, bytes


@pytest.mark.parametrize(
    "n_taxa, length, plan",
    [
        # 16 sites a block: 128 blocks on 132 SMs, up rows staged.
        (512, 2048, LaunchPlan(16, 128, 143_276, True)),
        # 16 KB of down table per site: S shrinks until both tables fit,
        # then to a multiple of 4.
        (2048, 1024, LaunchPlan(4, 256, 180_188, True)),
        (24, 300, LaunchPlan(3, 100, 1_324, True)),
        # Up rows no longer fit beside the table: the table alone.
        (10_000, 64, LaunchPlan(1, 64, 80_004, False)),
    ],
)
def test_launch_plan(n_taxa, length, plan):
    assert launch_plan(2 * n_taxa - 1, length, H100_OPTIN) == plan


def test_launch_plan_refuses_a_table_above_the_limit():
    n_all = 2 * 29_100 - 1  # one site's int32 down table: 232,796 bytes
    assert launch_plan(n_all, 64, 4 * n_all + 8).shared_bytes == 4 * n_all + 8
    with pytest.raises(ValueError, match="opt-in limit of 232448 bytes"):
        launch_plan(n_all, 64, H100_OPTIN)


def test_cpu_wrapper_runs_plain_and_counts_no_launch():
    var, up, t, weights = _random_variant(3)
    args = (torch.as_tensor(var), torch.as_tensor(up), t, torch.as_tensor(weights))
    before = insertion_delta_cuda.launches
    np.testing.assert_array_equal(
        insertion_delta_cuda(*args).numpy(), insertion_delta_plain(*args).numpy()
    )
    assert insertion_delta_cuda.launches == before


def test_wrapper_validates_inputs():
    var, up, t, weights = _random_variant(4)
    v, u, w = (torch.as_tensor(x) for x in (var, up, weights))
    with pytest.raises(TypeError):
        insertion_delta_cuda(v.long(), u, t, w)
    with pytest.raises(ValueError):
        insertion_delta_cuda(v, u[:-1], t, w)
    with pytest.raises(ValueError):
        insertion_delta_cuda(v, u, N_LEAVES, w)
    with pytest.raises(ValueError):
        insertion_delta_cuda(v, u, t, w[:-1])
