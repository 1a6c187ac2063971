"""``optimize_model`` (GTR+G) and ``optimize_branch_lengths`` of
``trex_tpu_torch/ops/likelihood.py`` against the JAX package's, from the same
inputs (numpy, seeded), at 30 Adam steps (``test_torch_model_fit_submodels.py``
and ``test_torch_model_fit_empirical.py`` hold the other models).

Adam's bias corrections are float32 in optax and float64 in torch
(ROADMAP.md, accepted differences), and ``torch.linalg.matrix_exp`` is not
JAX's Padé ``expm``, so the fits drift apart slowly: the first 20 losses
agree within rtol 1e-5, the last within 1e-4, and the fitted lengths and
model parameters within rtol 1e-2.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import evolved_masks, parents_of, random_children

import trex_tpu.ops.likelihood as jl
import trex_tpu_torch.ops.likelihood as tl
from trex_tpu.topology import Topology as JaxTopology
from trex_tpu_torch.topology import Topology

STEPS = 30


def _tree(rng, n):
    children = random_children(rng, n, 1)[0]
    parents = parents_of(children)
    return (children, JaxTopology(jnp.asarray(children), jnp.asarray(parents)),
            Topology(torch.as_tensor(children), torch.as_tensor(parents)))


def _compare(got, want, params=True):
    (p_t, losses_t), (p_j, losses_j) = got, want
    losses_j = np.asarray(losses_j)
    assert losses_t.shape == losses_j.shape == (STEPS,)
    np.testing.assert_allclose(losses_t[:20].numpy(), losses_j[:20], rtol=1e-5)
    np.testing.assert_allclose(float(losses_t[-1]), float(losses_j[-1]), rtol=1e-4)
    if params:
        assert list(p_t) == list(p_j)
        for key, value in p_j.items():
            np.testing.assert_allclose(p_t[key].numpy(), np.asarray(value), rtol=1e-2,
                                       atol=1e-4, err_msg=key)


@pytest.mark.parametrize("model", ["gtr+g"])
def test_optimize_model_matches(model):
    rng = np.random.default_rng(len(model))
    children, jax_topo, topo = _tree(rng, 7)
    masks = evolved_masks(rng, children, 40, 0.25)
    weights = rng.integers(1, 4, 40).astype(np.float32)
    got = tl.optimize_model(topo, torch.as_tensor(masks), 4, model=model, n_iterations=STEPS,
                            sequences_are_masks=True, site_weights=torch.as_tensor(weights))
    want = jl.optimize_model(jax_topo, jnp.asarray(masks), 4, model=model, n_iterations=STEPS,
                             sequences_are_masks=True, site_weights=jnp.asarray(weights))
    _compare(got, want)
    losses = got[1].numpy()
    assert losses[-1] < losses[0]


def test_optimize_branch_lengths_matches():
    rng = np.random.default_rng(4)
    children, jax_topo, topo = _tree(rng, 8)
    masks = evolved_masks(rng, children, 50, 0.2)
    got = tl.optimize_branch_lengths(topo, torch.as_tensor(masks), 4, n_iterations=STEPS,
                                     sequences_are_masks=True)
    want = jl.optimize_branch_lengths(jax_topo, jnp.asarray(masks), 4, n_iterations=STEPS,
                                      sequences_are_masks=True)
    _compare(({"branch_lengths": got[0]}, got[1]), ({"branch_lengths": want[0]}, want[1]))
