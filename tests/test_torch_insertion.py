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
    insertion_delta_cuda,
    insertion_delta_plain,
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
    including stale chain rows above the frontier."""
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
    ref = _pallas(var.numpy(), up_states.numpy(), t, st.weights.numpy())
    np.testing.assert_array_equal(ours.numpy(), ref)


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
