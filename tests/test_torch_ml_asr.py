"""Marginal and joint ML ancestral states and the posterior site rates of the
port against the JAX package, on a model the JAX package fitted (HKY+R3, 20
Adam steps) and carried across with ``model_params_from_numpy``, so the
functions are compared without the fit's drift.

Posteriors and site rates within rtol 2e-5 (atol 1e-6); MAP states equal
wherever the posterior's maximum leads by more than 1e-4; joint states
equal at every site but those where the two assignments have the same
joint probability (a tie, within 1e-4 in float64), and at most a tenth of
the sites.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import evolved_masks, parents_of, random_children

import trex_tpu.ops.likelihood as jl
import trex_tpu.ops.likelihood_asr as ja
import trex_tpu_torch.ops.likelihood as tl
import trex_tpu_torch.ops.likelihood_asr as ta
from trex_tpu.topology import Topology as JaxTopology
from trex_tpu_torch.topology import Topology


@pytest.fixture(scope="module")
def fitted():
    rng = np.random.default_rng(8)
    children = random_children(rng, 8, 1)[0]
    parents = parents_of(children)
    masks = evolved_masks(rng, children, 60, 0.35)
    masks[0, :3] = 15
    masks[3, 3:5] = 10  # C or T
    jax_topo = JaxTopology(jnp.asarray(children), jnp.asarray(parents))
    params, _ = jl.optimize_model(jax_topo, jnp.asarray(masks), 4, model="hky+r3",
                                  n_iterations=20, sequences_are_masks=True)
    numpy_params = {k: np.asarray(v) for k, v in params.items()}
    return dict(
        children=children, masks=masks, jax_topo=jax_topo, numpy=numpy_params,
        topo=Topology(torch.as_tensor(children), torch.as_tensor(parents)),
        torch=tl.model_params_from_numpy("hky+r3", numpy_params),
    )


def _args(f, pkg):
    p = f["numpy"] if pkg is ja else f["torch"]
    arr = jnp.asarray if pkg is ja else torch.as_tensor
    topo = f["jax_topo"] if pkg is ja else f["topo"]
    return (topo, arr(p["branch_lengths"]), arr(f["masks"]), 4, arr(p["rates"]),
            arr(p["freqs"]))


def test_marginal_posteriors(fitted):
    post_t, map_t = ta.marginal_ancestral_posteriors(*_args(fitted, ta),
                                                     sequences_are_masks=True)
    post_j, map_j = ja.marginal_ancestral_posteriors(*_args(fitted, ja),
                                                     sequences_are_masks=True)
    post_j = np.asarray(post_j)
    np.testing.assert_allclose(post_t.numpy(), post_j, rtol=2e-5, atol=1e-6)
    top2 = np.sort(post_j, axis=1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 1e-4
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(map_t.numpy()[clear], np.asarray(map_j)[clear])
    assert map_t.dtype == torch.int32


def _joint_log_prob(states, children, pmats, prior):
    """(L,) float64 log-probability of an assignment of every node's state."""
    n_leaves = children.shape[0] + 1
    sites = np.arange(states.shape[1])
    total = np.log(prior[states[-1]])
    for a, pair in enumerate(children):
        for c in pair:
            total = total + np.log(np.maximum(pmats[c][states[n_leaves + a], states[c]], 1e-30))
    return total


def test_joint_reconstruction(fitted):
    states_t, lp_t = ta.joint_ancestral_reconstruction(*_args(fitted, ta),
                                                       sequences_are_masks=True)
    states_j, lp_j = ja.joint_ancestral_reconstruction(*_args(fitted, ja),
                                                       sequences_are_masks=True)
    states_j = np.asarray(states_j)
    np.testing.assert_allclose(lp_t.numpy(), np.asarray(lp_j), rtol=2e-5, atol=1e-4)
    p = fitted["numpy"]
    pmats, prior, _ = ja._transitions(jnp.asarray(p["branch_lengths"]), 4,
                                      jnp.asarray(p["rates"]), jnp.asarray(p["freqs"]))
    pmats, prior = np.asarray(pmats, np.float64), np.asarray(prior, np.float64)
    differ = (states_t.numpy() != states_j).any(axis=0)
    assert differ.mean() <= 0.1
    ours = _joint_log_prob(states_t.numpy().astype(np.int64), fitted["children"], pmats, prior)
    theirs = _joint_log_prob(states_j.astype(np.int64), fitted["children"], pmats, prior)
    np.testing.assert_allclose(ours[differ], theirs[differ], atol=1e-4)
    # Leaves keep an allowed state.
    n_leaves = fitted["masks"].shape[0]
    leaf_states = states_t.numpy()[:n_leaves]
    assert ((fitted["masks"] >> leaf_states) & 1).all()


@pytest.mark.parametrize("kind", ["gamma", "freerate"])
def test_posterior_site_rates(fitted, kind):
    p_t, p_j = fitted["torch"], fitted["numpy"]
    if kind == "freerate":
        kw_t = dict(category_rates=p_t["category_rates"], category_weights=p_t["category_weights"])
        kw_j = dict(category_rates=jnp.asarray(p_j["category_rates"]),
                    category_weights=jnp.asarray(p_j["category_weights"]))
    else:
        kw_t = kw_j = {}
    rates_t, post_t = tl.posterior_site_rates(
        *_args(fitted, ta)[:4], 0.6, 4, p_t["rates"], p_t["freqs"],
        sequences_are_masks=True, **kw_t)
    rates_j, post_j = jax.jit(lambda *a: jl.posterior_site_rates(
        *a, sequences_are_masks=True, **kw_j), static_argnums=(3, 5))(
        *_args(fitted, ja)[:4], 0.6, 4, jnp.asarray(p_j["rates"]), jnp.asarray(p_j["freqs"]))
    np.testing.assert_allclose(post_t.numpy(), np.asarray(post_j), rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(rates_t.numpy(), np.asarray(rates_j), rtol=2e-5, atol=1e-6)
    assert post_t.shape == (3 if kind == "freerate" else 4, fitted["masks"].shape[1])
