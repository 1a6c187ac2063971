"""``optimize_model`` of ``trex_tpu_torch/ops/likelihood.py`` against the JAX
package's under empirical exchangeabilities at 20 states (+G, frequencies
fitted), from the same inputs (numpy, seeded), at 30 Adam steps.

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


def test_optimize_model_empirical_20_states():
    """Empirical exchangeabilities at Q = 20 (a seeded symmetric matrix, as a
    PAML file would give), +G, frequencies fitted; integer states with
    missing (-1) entries."""
    rng = np.random.default_rng(20)
    _, jax_topo, topo = _tree(rng, 6)
    fixed = rng.uniform(0.05, 3.0, (20, 20)).astype(np.float32)
    fixed = (fixed + fixed.T) / 2
    np.fill_diagonal(fixed, 0.0)
    states = rng.integers(-1, 20, (6, 30)).astype(np.int32)
    got = tl.optimize_model(topo, torch.as_tensor(states), 20, model="empirical+g",
                            n_iterations=STEPS, fixed_rates=torch.as_tensor(fixed))
    want = jl.optimize_model(jax_topo, jnp.asarray(states), 20, model="empirical+g",
                             n_iterations=STEPS, fixed_rates=jnp.asarray(fixed))
    _compare(got, want)
    with pytest.raises(ValueError, match="fixed_rates"):
        tl.optimize_model(topo, torch.as_tensor(states), 20, model="empirical")


