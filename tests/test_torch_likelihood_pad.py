"""K3/K4's zero-padding of the state count: the fixed kernels run Q <= 20 at
the least instantiated width W >= Q (``likelihood_cuda.kernel_width``), on a
P and a prior zero-padded to W. A padded state meets a zero row and column
of P and a zero prior, so every padded term adds +0 and the padded call
gives Q's result bit for bit. Held here through the plain version
(``batched_log_likelihood_plain``, the kernels' yardstick), and through the
wrapper's padding helper (``pad_states``), under a shared P and a P per
branch, on states with missing values and values >= Q and on masks of up to
8 states (bits >= Q set); also Q = 61 padded to 64, the runtime-Q kernel's
slot rows. Exact equality, no tolerance.
"""

import numpy as np
import pytest
import torch
from _torch_parity import integer_weights, random_children

from trex_tpu_torch.ops.likelihood import gtr_generator
from trex_tpu_torch.ops.likelihood_cuda import (
    WIDTHS,
    batched_log_likelihood_plain,
    kernel_width,
    pad_states,
    slot_states,
)

N_LEAVES, LENGTH, BATCH = 16, 200, 6


def _inputs(q: int, masks: bool, per_branch: bool, seed: int):
    rng = np.random.default_rng(seed)
    children = torch.as_tensor(random_children(rng, N_LEAVES, BATCH))
    if masks:
        # Up to 8 states: bits at and above Q set in some masks.
        leaves = rng.integers(1, 1 << min(q, 8), (N_LEAVES, LENGTH))
        high = rng.random(leaves.shape) < 0.03
        leaves[high] |= 1 << rng.integers(q, 8, int(high.sum())) if q < 8 else 0
    else:
        leaves = rng.integers(0, q, (N_LEAVES, LENGTH))
        leaves[rng.random(leaves.shape) < 0.05] = -1
        high = rng.random(leaves.shape) < 0.02
        leaves[high] = rng.integers(q, q + 6, int(high.sum()))
    rates = rng.gamma(2.0, 1.0, (q, q))
    freqs = torch.as_tensor(rng.dirichlet(np.full(q, 5.0)).astype(np.float32))
    gen = gtr_generator(torch.as_tensor(((rates + rates.T) / 2).astype(np.float32)), freqs)
    if per_branch:
        lengths = torch.as_tensor(
            rng.uniform(0.02, 0.6, (BATCH, 2 * N_LEAVES - 1, 1, 1)).astype(np.float32))
        transition = torch.linalg.matrix_exp(gen * lengths).contiguous()
    else:
        transition = torch.linalg.matrix_exp(gen * 0.1)
    weights = torch.as_tensor(integer_weights(rng, LENGTH))
    return children, torch.as_tensor(leaves.astype(np.int32)), weights, freqs, transition


def _zero_padded(x: torch.Tensor, width: int, dims: int) -> torch.Tensor:
    """``x`` written into zeros of ``width`` states by hand, independent of
    ``pad_states``."""
    out = torch.zeros(x.shape[: x.dim() - dims] + (width,) * dims, dtype=x.dtype)
    out[(...,) + (slice(0, x.shape[-1]),) * dims] = x
    return out


@pytest.mark.parametrize("q, width", [(2, 4), (3, 4), (5, 8), (7, 8), (13, 16), (61, 64)])
@pytest.mark.parametrize("per_branch", [False, True])
def test_zero_padding_is_exact(q, width, per_branch):
    children, leaves, weights, freqs, transition = _inputs(q, False, per_branch, q)
    want, want_rows = batched_log_likelihood_plain(
        children, leaves, weights, freqs, transition, per_site=True)
    got, got_rows = batched_log_likelihood_plain(
        children, leaves, weights, _zero_padded(freqs, width, 1),
        _zero_padded(transition, width, 2), per_site=True)
    assert torch.isfinite(want).all()
    assert torch.equal(got_rows, want_rows) and torch.equal(got, want)


@pytest.mark.parametrize("q", [2, 3, 5, 7])
@pytest.mark.parametrize("per_branch", [False, True])
def test_zero_padding_is_exact_on_masks(q, per_branch):
    children, leaves, weights, freqs, transition = _inputs(q, True, per_branch, 100 + q)
    width = kernel_width(q)
    want = batched_log_likelihood_plain(children, leaves, weights, freqs, transition,
                                        sequences_are_masks=True)
    got = batched_log_likelihood_plain(
        children, leaves, weights, _zero_padded(freqs, width, 1),
        _zero_padded(transition, width, 2), sequences_are_masks=True)
    assert torch.equal(got, want)


@pytest.mark.parametrize("q", [2, 3, 5, 6, 7, 9, 11, 13, 17, 19])
@pytest.mark.parametrize("per_branch", [False, True])
def test_pad_states_gives_the_unpadded_call(q, per_branch):
    """The wrapper's helper pads what the card's fixed kernel reads (a P
    per branch; the kernel pads a shared P and the prior itself)."""
    children, leaves, weights, freqs, transition = _inputs(q, False, per_branch, 200 + q)
    width = kernel_width(q)
    padded = pad_states(transition, width, 2)
    assert padded.shape[-2:] == (width, width)
    assert torch.equal(padded, _zero_padded(transition, width, 2))
    want = batched_log_likelihood_plain(children, leaves, weights, freqs, transition)
    got = batched_log_likelihood_plain(children, leaves, weights,
                                       pad_states(freqs, width, 1), padded)
    assert torch.equal(got, want)


def test_pad_states_returns_a_full_width_input_itself():
    p = torch.eye(8)
    assert pad_states(p, 8, 2) is p


def test_kernel_widths():
    assert WIDTHS == (4, 8, 12, 16, 20)
    assert [kernel_width(q) for q in range(2, 22)] == (
        [4] * 3 + [8] * 4 + [12] * 4 + [16] * 4 + [20] * 4 + [0])
    assert [slot_states(q) for q in (21, 32, 33, 61, 64, 65, 240)] == [
        32, 32, 48, 64, 64, 80, 240]
