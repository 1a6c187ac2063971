"""Topology tests (``search/topotest.py``: KH, SH, BP, ELW, AU) and the
batched fit's per-site rows against the JAX package on the same numpy
inputs and the JAX package's draws (the replicates and the AU scales').
Shapes: 8 taxa x 60 patterns, 9 trees, 3 Newton sweeps, 200 replicates,
2 AU scales."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import (
    evolved_masks,
    integer_weights,
    jax_au_draws,
    near_tie_replicates,
    parents_of,
    random_children,
)

import trex_tpu.search.bootstrap as jax_bootstrap
import trex_tpu.search.topotest as jax_topotest
from trex_tpu.topology import Topology as JaxTopology
from trex_tpu_torch.io import nni_neighbors_host
from trex_tpu_torch.ops.likelihood_asr import per_site_matrix
from trex_tpu_torch.search import topotest
from trex_tpu_torch.search.ufboot import _unrooted_split_masks
from trex_tpu_torch.topology import from_numpy

N_TAXA, N_SITES, SWEEPS, REPLICATES, SEED = 8, 60, 3, 200, 0
AU_SCALES = (0.8, 1.2)


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(5)
    children = random_children(rng, N_TAXA, 1)[0]
    parents = parents_of(children)
    masks = evolved_masks(rng, children, N_SITES, 0.2)
    masks[rng.random(masks.shape) < 0.05] = 5  # ambiguous A/G
    weights = integer_weights(rng, N_SITES)
    nni_children, nni_parents = nni_neighbors_host(from_numpy(children, parents))
    other = random_children(rng, N_TAXA, 1)
    pool_children = np.concatenate([children[None], nni_children, other])
    pool_parents = np.concatenate([parents[None], nni_parents, parents_of(other)])
    # Distinct unrooted trees only: a re-rooting ties its tree's likelihood
    # exactly, and float rounding may then flip votes.
    seen, keep = set(), []
    for i in range(pool_children.shape[0]):
        sig = frozenset(_unrooted_split_masks(pool_children[i]))
        if sig not in seen and (len(keep) < 8 or i == pool_children.shape[0] - 1):
            seen.add(sig)
            keep.append(i)
    trees_children, trees_parents = pool_children[keep], pool_parents[keep]
    key = jax.random.PRNGKey(SEED)
    want = jax_topotest.topology_tests(
        key, JaxTopology(children=jnp.asarray(trees_children),
                         parents=jnp.asarray(trees_parents)),
        jnp.asarray(masks), 4, site_weights=jnp.asarray(weights), n_replicates=REPLICATES,
        n_sweeps=SWEEPS, sequences_are_masks=True, au_scales=None)
    want_au = jax_topotest._au_test(
        jax.random.fold_in(key, 7), jnp.asarray(want.per_site, jnp.float32),
        jnp.asarray(weights), REPLICATES, AU_SCALES)
    draws = np.array(jax_bootstrap._replicate_weights(key, N_SITES, REPLICATES,
                                                      jnp.asarray(weights)))
    return dict(masks=masks, weights=weights, trees=from_numpy(trees_children, trees_parents),
                want=want, want_au=want_au, draws=draws,
                au_draws=jax_au_draws(SEED, weights, REPLICATES, AU_SCALES))


def _rows(case) -> torch.Tensor:
    return per_site_matrix(case["trees"], torch.as_tensor(case["masks"]), 4,
                           weights=torch.as_tensor(case["weights"]), n_sweeps=SWEEPS,
                           sequences_are_masks=True)


def test_per_site_rows_match_jax(case):
    rows = _rows(case).numpy().astype(np.float64)
    want = case["want"]
    totals = rows @ case["weights"].astype(np.float64)
    np.testing.assert_allclose(totals, want.log_likelihoods, rtol=2e-5)
    worst = float(np.abs(rows - want.per_site).max())
    print(f"largest per-site difference: {worst:.3g}")
    assert worst <= 1e-4


def test_topology_tests_match_jax(case):
    got = topotest.topology_tests(
        case["trees"], torch.as_tensor(case["masks"]), 4,
        site_weights=torch.as_tensor(case["weights"]), n_sweeps=SWEEPS,
        sequences_are_masks=True, replicate_weights=case["draws"],
        au_scales=AU_SCALES, au_weights=case["au_draws"])
    want = case["want"]
    assert got.best_index == want.best_index
    np.testing.assert_allclose(got.log_likelihoods, want.log_likelihoods, rtol=2e-5)
    np.testing.assert_allclose(got.delta, want.delta, rtol=0, atol=1e-2)
    # A replicate whose deciding quantities lie within 1e-5 of the totals,
    # relative, may decide the other way between two float32
    # implementations: each such replicate may move one vote.
    rows = _rows(case).numpy().astype(np.float64)
    obs = rows @ case["weights"].astype(np.float64)
    scale = 1e-5 * np.abs(obs).max()
    rell = case["draws"].astype(np.float64) @ rows.T
    bp_ties = near_tie_replicates(rell)
    centered = rell - obs[None, :]
    centered = centered - centered.mean(axis=0, keepdims=True)
    best = want.best_index
    kh_ties = [0 if t == best else int(np.sum(
        np.abs(centered[:, best] - centered[:, t] - want.delta[t]) <= scale))
        for t in range(len(obs))]
    sh_ties = [int(np.sum(np.abs(centered.max(axis=1) - centered[:, t] - want.delta[t])
                          <= scale)) for t in range(len(obs))]
    au_ties = [near_tie_replicates(d.astype(np.float64) @ rows.T) for d in case["au_draws"]]
    print(f"near-tied replicates: bp {bp_ties}, kh {kh_ties}, sh {sh_ties}, au {au_ties}")
    np.testing.assert_allclose(got.bp, want.bp, rtol=0, atol=bp_ties / REPLICATES + 1e-12)
    for t in range(len(obs)):
        assert abs(got.p_kh[t] - want.p_kh[t]) <= kh_ties[t] / REPLICATES + 1e-12
        assert abs(got.p_sh[t] - want.p_sh[t]) <= sh_ties[t] / REPLICATES + 1e-12
    # ELW: the mean of softmax weights of the replicate totals.
    print(f"largest ELW difference: {np.abs(got.elw - want.elw).max():.3g}")
    np.testing.assert_allclose(got.elw, want.elw, rtol=0, atol=1e-4)
    # The AU fit reads each scale's win shares; with no near tie at any
    # scale it is the JAX package's within 1e-6 (else test_au_test_on_jax_rows
    # holds the fit on the JAX package's own rows).
    if not any(au_ties):
        np.testing.assert_allclose(got.p_au, case["want_au"], rtol=0, atol=1e-6)


def test_au_test_on_jax_rows(case):
    """The AU fit alone, on the JAX package's rows and draws."""
    got = topotest._au_test(torch.as_tensor(case["want"].per_site, dtype=torch.float32),
                            case["au_draws"], REPLICATES, AU_SCALES)
    np.testing.assert_allclose(got, case["want_au"], rtol=0, atol=1e-6)


def test_au_draws_from_a_generator(case):
    """Without handed-over draws the AU scales come from the generator:
    round(total x r) patterns a replicate, only patterns of nonzero weight."""
    weights = case["weights"].copy()
    weights[:5] = 0
    counts = topotest.au_replicate_weights(weights, 50, AU_SCALES,
                                           torch.Generator().manual_seed(1))
    for r, c in zip(AU_SCALES, counts, strict=True):
        assert c.shape == (50, N_SITES)
        assert (c.sum(dim=1) == round(weights.sum() * r)).all()
        assert (c[:, :5] == 0).all()


def test_two_trees_needed(case):
    one = from_numpy(case["trees"].children[:1].numpy(), case["trees"].parents[:1].numpy())
    with pytest.raises(ValueError, match="at least two"):
        topotest.topology_tests(one, torch.as_tensor(case["masks"]), 4,
                                sequences_are_masks=True)
