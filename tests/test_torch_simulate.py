"""The port's simulator (``models/simulate.py``) against the JAX package's:
the host walk equal state for state under the numpy seed that JAX derives
from its key (JC, GTR+G+I, protein, ancestors), ``simulate_coalescent``
equal in topology and ages (serial tips too); the device path (here on
the CPU, forced) against the closed-form checks of the JAX package's
``tests/test_simulate.py::test_device_path_statistics``; and the rule
that picks the path."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import parents_of, random_children

import trex_tpu.models.simulate as jsim
from trex_tpu.topology import Topology as JaxTopology
from trex_tpu_torch.models import simulate as sim
from trex_tpu_torch.topology import balanced_topology, from_numpy


def _jax_seed(key) -> int:
    return int(jax.random.randint(key, (), 0, 2**31 - 1))


def _trees(seed, n):
    children = random_children(np.random.default_rng(seed), n, 1)[0]
    blens = np.random.default_rng(seed + 1).exponential(0.15, 2 * n - 1)
    return (from_numpy(children, parents_of(children)),
            JaxTopology(jnp.asarray(children), jnp.asarray(parents_of(children))), blens)


@pytest.mark.parametrize("case", ["jc", "gtr+g+i", "protein", "ancestors"])
def test_host_walk_equals_jax(case):
    topo, jtopo, blens = _trees(3, 9)
    rng = np.random.default_rng(4)
    kw = dict(n_sites=70)
    if case == "gtr+g+i":
        rates = rng.gamma(2.0, 1.0, (4, 4))
        kw.update(rates=(rates + rates.T) / 2, freqs=rng.dirichlet(np.full(4, 5.0)),
                  gamma_shape=0.6, p_invariant=0.2)
    elif case == "protein":
        rates = rng.gamma(2.0, 1.0, (20, 20))
        kw.update(n_states=20, rates=(rates + rates.T) / 2,
                  freqs=rng.dirichlet(np.full(20, 5.0)), gamma_shape=1.2, n_categories=3)
    elif case == "ancestors":
        kw.update(return_ancestors=True)
    key = jax.random.PRNGKey(7)
    want = jsim.simulate_alignment(key, jtopo, blens, **kw)
    got = sim.simulate_alignment(_jax_seed(key), topo, blens, device="cpu", **kw)
    for ours, ref in zip(*((got, want) if case == "ancestors" else ((got,), (want,)))):
        assert ours.dtype == np.int32
        np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("tips", [None, [0.0, 0.3, 0.0, 1.1, 0.2, 0.0, 2.5]])
def test_coalescent_equals_jax(tips):
    tip_ages = None if tips is None else np.array(tips)
    topo, ages = sim.simulate_coalescent(5, 7, 0.8, tip_ages=tip_ages)
    jtopo, jages = jsim.simulate_coalescent(5, 7, 0.8, tip_ages=tip_ages)
    np.testing.assert_array_equal(topo.children.numpy(), np.asarray(jtopo.children))
    np.testing.assert_array_equal(topo.parents.numpy(), np.asarray(jtopo.parents))
    np.testing.assert_array_equal(ages, jages)
    assert ages.dtype == np.float32


def _device(topo, blens, seed, **kw):
    return sim.simulate_alignment(seed, topo, np.asarray(blens, np.float64), device="cpu",
                                  device_path=True, **kw)


def test_device_path_statistics():
    # Determinism and shapes.
    topo = balanced_topology(8)
    blens = np.full((topo.n_all,), 0.1)
    a = _device(topo, blens, 0, n_sites=64)
    np.testing.assert_array_equal(a, _device(topo, blens, 0, n_sites=64))
    assert a.shape == (8, 64) and a.dtype == np.int32 and (a >= 0).all() and (a < 4).all()
    gen = torch.Generator().manual_seed(0)
    np.testing.assert_array_equal(a, _device(topo, blens, 99, n_sites=64, rng=gen))
    # Zero branch lengths copy the root exactly.
    leaves, anc = _device(topo, np.zeros(topo.n_all), 1, n_sites=50, return_ancestors=True)
    assert (leaves == anc[-1][None, :]).all() and (anc == anc[-1][None, :]).all()
    # JC expected identity on one branch.
    t = 0.3
    leaves, anc = _device(balanced_topology(2), [t, 0.0, 0.0], 3, n_sites=20000,
                          return_ancestors=True)
    np.testing.assert_array_equal(leaves[1], anc[-1])
    assert abs(float((leaves[0] == leaves[1]).mean()) - (0.25 + 0.75 * np.exp(-4 * t / 3))) < 0.02
    # Long branches reach the stationary distribution.
    big = balanced_topology(64)
    freqs = np.array([0.5, 0.3, 0.15, 0.05])
    leaves = _device(big, np.full(big.n_all, 50.0), 2, n_sites=400, freqs=freqs)
    np.testing.assert_allclose(np.bincount(leaves.ravel(), minlength=4) / leaves.size, freqs,
                               atol=0.02)
    # Invariant-category sites are exactly constant; the constant share is
    # Binomial(2000, 0.5) / 2000, bounded at +/- 4 sd.
    mid = balanced_topology(16)
    leaves = _device(mid, np.full(mid.n_all, 0.5), 4, n_sites=2000, p_invariant=0.5)
    constant = (leaves == leaves[0:1]).all(axis=0).mean()
    assert 0.455 < constant < 0.545
    no_inv = _device(mid, np.full(mid.n_all, 0.5), 4, n_sites=2000)
    assert (no_inv == no_inv[0:1]).all(axis=0).mean() < constant - 0.2


def test_depth_levels_walk_root_first():
    topo, _, _ = _trees(6, 30)
    children = topo.children.numpy()
    levels = sim.depth_levels(children)
    assert list(levels[0]) == [28]
    assert sorted(np.concatenate(levels)) == list(range(29))
    seen = {28}
    for level in levels[1:]:
        for a in level:  # every ancestor's parent sits at an earlier level
            parent = int(np.argwhere(children == 30 + a)[0, 0])
            assert parent in seen
        seen.update(int(a) for a in level)


def test_auto_select_rule():
    assert sim.DEVICE_CELLS == 2**22 == jsim._DEVICE_CELLS
    assert sim.use_device_path("cuda", 16383, 1024)  # the 8192-taxon harness
    assert sim.use_device_path("cuda", 2**11, 2**11)
    assert not sim.use_device_path("cuda", 2**11, 2**11 - 1)
    assert not sim.use_device_path("cpu", 16383, 1024)
    assert not sim.use_device_path(torch.device("cpu"), 10**6, 10**6)
    # On the CPU every size takes the host walk: its bytes are the JAX walk's.
    topo, jtopo, blens = _trees(8, 5)
    key = jax.random.PRNGKey(2)
    np.testing.assert_array_equal(
        sim.simulate_alignment(_jax_seed(key), topo, blens, n_sites=40, device="cpu"),
        jsim.simulate_alignment(key, jtopo, blens, n_sites=40))
