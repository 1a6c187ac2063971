"""The port's sampler alone against exact posteriors (the oracles of
``tests/test_mcmc.py``), on its own torch draws:

- the 5-taxon topology posterior at fixed equal lengths against the
  softmax of the 105 rooted trees' log-likelihoods (total variation below
  0.08; at most 0.029 on seeds 3-6), pooling 16 independent runs of 600
  generations;
- the 2-taxon branch-length posterior against 1-D quadrature;
- a stopped-and-resumed run bit-identical to an uninterrupted one.

Alignments simulated with numpy from a seed (JC69)."""

import numpy as np
import pytest
import torch
from _torch_parity import random_children  # noqa: F401  (one PyTorch thread a worker)

from trex_tpu_torch.io import sample_topologies, spr_move
from trex_tpu_torch.ops.likelihood_cuda import batched_log_likelihood_plain
from trex_tpu_torch.ops.likelihood import jc69_transition
from trex_tpu_torch.search import mcmc
from trex_tpu_torch.topology import Topology


def simulate_jc(rng, children: np.ndarray, lengths: np.ndarray, n_sites: int) -> np.ndarray:
    """(n_leaves, L) int32 JC69 states down a tree of per-node lengths."""
    n_leaves = children.shape[0] + 1
    seqs = np.empty((2 * n_leaves - 1, n_sites), np.int64)
    seqs[-1] = rng.integers(0, 4, n_sites)
    for a in range(n_leaves - 2, -1, -1):
        for c in children[a]:
            p_change = 0.75 * (1.0 - np.exp(-4.0 / 3.0 * lengths[c]))
            s = seqs[n_leaves + a].copy()
            hit = rng.random(n_sites) < p_change
            s[hit] = rng.integers(0, 4, int(hit.sum()))
            seqs[c] = s
    return seqs[:n_leaves].astype(np.int32)


def all_rooted_5leaf(start: Topology) -> dict[bytes, np.ndarray]:
    seen = {start.children.numpy().tobytes(): start}
    frontier = [start]
    while frontier:
        nxt = []
        for topo in frontier:
            for p in range(topo.n_all - 1):
                for v in range(topo.n_all - 1):
                    moved = spr_move(topo, p, v)
                    if moved is not None and moved.children.numpy().tobytes() not in seen:
                        seen[moved.children.numpy().tobytes()] = moved
                        nxt.append(moved)
        frontier = nxt
    return {k: t.children.numpy() for k, t in seen.items()}


@pytest.mark.parametrize("n_chains,power", [(1, 0.1), (2, 0.5)])
def test_topology_posterior_matches_enumeration(n_chains, power):
    truth_np = sample_topologies(5, 5, 1, device="cpu")
    truth = Topology(truth_np.children[0], truth_np.parents[0])
    bl = 0.2
    leaves = simulate_jc(np.random.default_rng(2), truth.children.numpy(),
                         np.full(9, bl), 60)
    trees = all_rooted_5leaf(truth)
    assert len(trees) == 105
    keys = list(trees)
    children = torch.as_tensor(np.stack([trees[k] for k in keys]))
    lnls = batched_log_likelihood_plain(
        children, torch.as_tensor(leaves), torch.ones(60), torch.full((4,), 0.25),
        jc69_transition(torch.full((105, 9), bl), 4)).numpy().astype(np.float64)
    post = np.exp(lnls - lnls.max())
    exact = dict(zip(keys, post / post.sum()))
    res = mcmc.mcmc_sample(
        leaves, 4, seed=3, device="cpu", n_generations=600, n_runs=16, n_chains=n_chains,
        sample_every=2, burnin_frac=0.15, branch_moves_per_gen=0,
        topo_informed_power=power, start=truth, start_lengths=np.full(9, bl, np.float32))
    counts: dict[bytes, int] = {}
    for c in res.sample_children:
        counts[c.tobytes()] = counts.get(c.tobytes(), 0) + 1
    n = sum(counts.values())
    assert set(counts) <= set(keys)  # the chains stay on canonical trees
    tvd = 0.5 * sum(abs(counts.get(k, 0) / n - exact[k]) for k in keys)
    assert tvd < 0.08
    if n_chains > 1:
        assert res.acceptance["swap"] > 0.2


def test_two_taxon_branch_posterior_matches_quadrature():
    rng = np.random.default_rng(0)
    length = 300
    a = rng.integers(0, 4, length)
    b = np.where(rng.uniform(size=length) < 0.15, (a + rng.integers(1, 4, length)) % 4, a)
    leaves = np.stack([a, b]).astype(np.int32)
    # Only s = t0 + t1 is visible to a reversible model; its prior is
    # Gamma(2, rate).
    grid = np.linspace(1e-4, 1.5, 2000)
    lengths = np.zeros((grid.size, 3), np.float32)
    lengths[:, 0] = grid
    lnl = batched_log_likelihood_plain(
        torch.zeros((grid.size, 1, 2), dtype=torch.int32) + torch.tensor([0, 1], dtype=torch.int32),
        torch.as_tensor(leaves), torch.ones(length), torch.full((4,), 0.25),
        jc69_transition(torch.as_tensor(lengths), 4)).numpy().astype(np.float64)
    logpost = lnl + np.log(grid) - 10.0 * grid
    w = np.exp(logpost - logpost.max())
    w /= w.sum()
    mean_exact = float((w * grid).sum())
    sd_exact = float(np.sqrt((w * (grid - mean_exact) ** 2).sum()))
    res = mcmc.mcmc_sample(
        leaves, 4, seed=1, device="cpu", n_generations=1000, n_runs=4, n_chains=1,
        sample_every=4, burnin_frac=0.25, brlen_prior_mean=0.1, topo_moves=False,
        branch_moves_per_gen=2)
    s = res.sample_lengths[:, 0] + res.sample_lengths[:, 1]
    assert abs(s.mean() - mean_exact) < 4 * sd_exact / np.sqrt(max(res.ess_lnl, 50.0)) + 0.005
    assert abs(s.std() - sd_exact) < 0.012
    assert res.acceptance["branch"] > 0.2


def test_resume_is_bit_identical(tmp_path):
    rng = np.random.default_rng(7)
    children = sample_topologies(8, 6, 1, device="cpu").children[0].numpy()
    leaves = simulate_jc(rng, children, rng.uniform(0.05, 0.2, 11), 80)
    kw = dict(seed=4, device="cpu", n_generations=60, n_runs=2, n_chains=2, sample_every=10,
              branch_moves_per_gen=2, checkpoint_every=20)
    whole = mcmc.mcmc_sample(leaves, 4, checkpoint_dir=str(tmp_path / "whole"), **kw)
    legs = str(tmp_path / "legs")
    mcmc.mcmc_sample(leaves, 4, checkpoint_dir=legs, stop_after_generations=20, **kw)
    mcmc.mcmc_sample(leaves, 4, checkpoint_dir=legs, stop_after_generations=20, **kw)
    resumed = mcmc.mcmc_sample(leaves, 4, checkpoint_dir=legs, **kw)
    for field in ("sample_children", "sample_lengths", "sample_lnl", "sample_run",
                  "mean_lengths"):
        np.testing.assert_array_equal(getattr(resumed, field), getattr(whole, field))
    assert resumed.acceptance == whole.acceptance
    assert resumed.consensus_newick == whole.consensus_newick
    a = np.load(str(tmp_path / "whole" / "mcmc_checkpoint.npz"))
    b = np.load(legs + "/mcmc_checkpoint.npz")
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_draws_are_distributed_as_named():
    """The generator source's gamma, Dirichlet and Gumbel draws: moments
    within four standard errors (shape 0.3 takes the boosted branch)."""
    draws = mcmc.TorchDraws(torch.Generator().manual_seed(0))
    n = 20000
    for shape in (0.3, 1.0, 4.5, 200.0):
        x = draws.gamma(shape, (n,)).double()
        assert abs(x.mean() - shape) < 4 * np.sqrt(shape / n)
        assert abs(x.var() - shape) < 8 * shape * np.sqrt(2.0 / n) * max(1.0, np.sqrt(6 / shape))
    alpha = torch.tensor([[500.0 * 0.2, 500.0 * 0.5, 500.0 * 0.3]]).expand(n, 3)
    d = draws.dirichlet(alpha).double()
    assert torch.allclose(d.sum(-1), torch.ones(n, dtype=torch.float64), atol=1e-5)
    np.testing.assert_allclose(d.mean(0).numpy(), [0.2, 0.5, 0.3], atol=4 * 0.025 / np.sqrt(n))
    g = draws.gumbel((n,)).double()
    assert abs(g.mean() - 0.5772156649) < 4 * 1.2825 / np.sqrt(n)
    u = draws.randint((n,), 0, 5)
    assert u.min() == 0 and u.max() == 4
    state = draws.get_state()
    first = draws.uniform((4,))
    draws.set_state(state)
    assert torch.equal(draws.uniform((4,)), first)
    assert mcmc.TorchDraws(torch.Generator(), device="cpu").normal((3,)).shape == (3,)

