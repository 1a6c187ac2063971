"""Node-age dating (``search/dating.py``)
against the JAX package on the same numpy inputs: ``mcmc_date`` replayed
under the JAX key schedule (``_torch_parity.JaxDraws``) from the same
start ages for the strict clock; the relaxed clock under a coalescent
prior with Ne sampled and a calibrated clade; and tip dating; the same
accepts, ages, rates, clock rates and Ne within rtol 2e-5, no near-tied
accept (``test_torch_clock.py``: the clock's functions). 7 taxa x 120
sites, 30 generations."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import (
    JaxDraws,
    evolved_masks,
    jax_dating_step,
    near_tie_accepts,
    parents_of,
    random_children,
    record_accepts,
)

import trex_tpu.search.dating as jax_dating
from trex_tpu.topology import Topology as JaxTopology
from trex_tpu_torch.alignment import compress_alignment
from trex_tpu_torch.ops import clock
from trex_tpu_torch.search import dating
from trex_tpu_torch.topology import from_numpy

N_TAXA, GENERATIONS = 7, 30


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(21)
    children = random_children(rng, N_TAXA, 1)[0]
    masks = evolved_masks(rng, children, 120, 0.1)
    patterns, weights = compress_alignment(masks)
    parents = parents_of(children)
    increments = rng.uniform(0.02, 0.08, N_TAXA - 1).astype(np.float32)
    topo = from_numpy(children, parents)
    ages = clock.increments_to_ages(topo, torch.as_tensor(increments)).numpy()
    return dict(children=children, parents=parents, patterns=patterns.astype(np.int32),
                weights=weights.astype(np.float32), ages=ages, topo=topo,
                jax_topo=JaxTopology(children=jnp.asarray(children), parents=jnp.asarray(parents)))


def clade_of(children, n_leaves, size_lo=2, size_hi=4):
    sets = {i: {i} for i in range(n_leaves)}
    for a, (x, y) in enumerate(children):
        sets[n_leaves + a] = sets[int(x)] | sets[int(y)]
        if size_lo <= len(sets[n_leaves + a]) <= size_hi:
            return frozenset(sets[n_leaves + a])
    raise AssertionError("no clade of that size")


CASES = {
    "strict": (dict(), 3),
    "relaxed_coalescent_calibrated": (dict(clock="relaxed", tree_prior="coalescent"), 4),
    "tip_dated": (dict(tip_ages=np.linspace(0.0, 0.03, N_TAXA).astype(np.float32)), 5),
}


@pytest.mark.parametrize("name", list(CASES))
def test_replayed_dating_equals_jax(case, name, monkeypatch):
    kw, seed = CASES[name]
    kw = dict(kw)
    if name.startswith("relaxed"):
        clade = clade_of(case["children"], N_TAXA)
        kw["calibrations"] = {clade: (0.0, 0.5)}
    common = dict(n_generations=GENERATIONS, n_chains=2, sample_every=2,
                  start_ages=case["ages"], sequences_are_masks=True, **kw)
    want = jax_dating.mcmc_date(jax.random.PRNGKey(seed), case["jax_topo"],
                                jnp.asarray(case["patterns"]), 4,
                                site_weights=jnp.asarray(case["weights"]), **common)
    calibrated = "calibrations" in kw or "tip_ages" in kw
    state, step = jax_dating_step(
        jax.random.PRNGKey(seed), GENERATIONS, interior=True,
        relaxed=kw.get("clock") == "relaxed", calibrated=calibrated,
        heterochronous="tip_ages" in kw, sample_ne=kw.get("tree_prior") == "coalescent")
    margins = record_accepts(monkeypatch)
    got = dating.mcmc_date(case["topo"], case["patterns"], 4, seed=seed,
                           draws=JaxDraws(state, step), device="cpu",
                           site_weights=case["weights"], **common)
    assert near_tie_accepts(margins, float(np.abs(got.sample_lnl).max())) == 0
    assert got.acceptance == want.acceptance
    np.testing.assert_allclose(got.sample_ages, want.sample_ages, rtol=2e-5, atol=1e-7)
    np.testing.assert_allclose(got.sample_lnl, want.sample_lnl, rtol=2e-5)
    np.testing.assert_allclose(got.age_hpd, want.age_hpd, rtol=2e-5, atol=1e-7)
    assert got.ess_root_age == pytest.approx(want.ess_root_age, rel=1e-3)
    for field in ("sample_rates", "sample_clock_rate", "sample_ne"):
        a, b = getattr(got, field), getattr(want, field)
        assert (a is None) == (b is None), field
        if b is not None:
            np.testing.assert_allclose(a, b, rtol=2e-5, err_msg=field)
    if name.startswith("relaxed"):
        assert set(want.acceptance) == {"slide", "root", "rate", "clock_rate"}
        assert want.sample_ne is not None and want.sample_rates is not None
