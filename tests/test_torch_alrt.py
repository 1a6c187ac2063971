"""aLRT / SH-aLRT / RELL branch supports (``search/alrt.py``), the batched
Newton fit (``ops/likelihood_asr.py::per_site_matrix``) and K3/K4's per-site
mode (its plain version) against the JAX package and the port's own
single-tree fit, on the same numpy inputs and the JAX package's replicate
draws. Shapes: 8 taxa x 60 patterns, 3 Newton sweeps, 200 replicates."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import (
    evolved_masks,
    integer_weights,
    near_tie_replicates,
    parents_of,
    random_children,
)

import trex_tpu.search.alrt as jax_alrt
import trex_tpu.search.bootstrap as jax_bootstrap
from trex_tpu.topology import Topology as JaxTopology
from trex_tpu_torch.ops.likelihood import per_site_log_likelihood
from trex_tpu_torch.ops.likelihood_asr import optimize_branch_lengths_newton, per_site_matrix
from trex_tpu_torch.ops.likelihood_cuda import (
    batched_log_likelihood_cuda,
    batched_log_likelihood_plain,
)
from trex_tpu_torch.search import alrt
from trex_tpu_torch.topology import Topology, from_numpy

N_TAXA, N_SITES, SWEEPS, REPLICATES = 8, 60, 3, 200
GTR = (np.array([[0, 1.2, 4.0, 0.6], [1.2, 0, 0.9, 3.3], [4.0, 0.9, 0, 1.0],
                 [0.6, 3.3, 1.0, 0]], np.float32),
       np.array([0.3, 0.2, 0.22, 0.28], np.float32))


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(2)
    children = random_children(rng, N_TAXA, 1)[0]
    masks = evolved_masks(rng, children, N_SITES, 0.15)
    masks[rng.random(masks.shape) < 0.05] = 15  # missing data
    weights = integer_weights(rng, N_SITES)
    parents = parents_of(children)
    jax_topo = JaxTopology(children=jnp.asarray(children), parents=jnp.asarray(parents))
    key = jax.random.PRNGKey(7)
    want = jax_alrt.branch_supports(
        key, jax_topo, jnp.asarray(masks), 4, site_weights=jnp.asarray(weights),
        n_replicates=REPLICATES, n_sweeps=SWEEPS, sequences_are_masks=True)
    draws = np.array(jax_bootstrap._replicate_weights(key, N_SITES, REPLICATES,
                                                      jnp.asarray(weights)))
    return dict(children=children, parents=parents, masks=masks, weights=weights,
                jax_topo=jax_topo, want=want, draws=draws)


def _topology(case) -> Topology:
    return from_numpy(case["children"], case["parents"])


def test_alternatives_by_edge_match_jax(case):
    got_children, got_parents, got_edges = alrt._nni_alternatives_by_edge(_topology(case))
    want_batch, want_edges = jax_alrt._nni_alternatives_by_edge(case["jax_topo"])
    np.testing.assert_array_equal(got_children, np.asarray(want_batch.children))
    np.testing.assert_array_equal(got_parents, np.asarray(want_batch.parents))
    assert got_edges == want_edges
    got_alt = alrt._root_edge_alternatives(_topology(case))
    want_alt = jax_alrt._root_edge_alternatives(case["jax_topo"])
    for got, want in zip(got_alt, want_alt, strict=True):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_branch_supports_match_jax(case):
    topo = _topology(case)
    got = alrt.branch_supports(
        topo, torch.as_tensor(case["masks"]), 4, site_weights=torch.as_tensor(case["weights"]),
        n_sweeps=SWEEPS, sequences_are_masks=True, replicate_weights=case["draws"])
    want = case["want"]
    assert abs(got.log_likelihood - want.log_likelihood) <= 2e-5 * abs(want.log_likelihood)
    np.testing.assert_array_equal(np.isnan(got.alrt), np.isnan(want.alrt))
    tested = ~np.isnan(want.alrt)
    np.testing.assert_allclose(got.alrt[tested], want.alrt[tested], rtol=0, atol=1e-2)
    # Near-tied replicates (top two RELL totals within 1e-5 relative) may
    # flip their vote between the two implementations: count them per edge.
    children, parents, by_edge = alrt._nni_alternatives_by_edge(topo)
    used = sorted({m for rows in by_edge for m in rows})
    rows = per_site_matrix(
        from_numpy(np.concatenate([case["children"][None], children[used]]),
                   np.concatenate([case["parents"][None], parents[used]])),
        torch.as_tensor(case["masks"]), 4, weights=torch.as_tensor(case["weights"]),
        n_sweeps=SWEEPS, sequences_are_masks=True).numpy()
    totals = case["draws"].astype(np.float64) @ rows.T.astype(np.float64)
    remap = {m: i + 1 for i, m in enumerate(used)}
    ties = 0
    for i, edge_rows in enumerate(by_edge):
        if edge_rows:
            allowed = near_tie_replicates(totals[:, [0] + [remap[m] for m in edge_rows]])
            ties += allowed
            assert abs(got.sh_alrt[i] - want.sh_alrt[i]) <= allowed / REPLICATES
            assert abs(got.rell[i] - want.rell[i]) <= allowed / REPLICATES
    print(f"near-tied replicate votes: {ties}")
    assert ties == 0


def test_per_site_matrix_equals_single_tree_fit():
    """Every row equals the port's single-tree Newton fit + per-site pass,
    within rtol 1e-5, for two chunk sizes, under JC and GTR."""
    rng = np.random.default_rng(4)
    children = random_children(rng, N_TAXA, 7)
    masks = evolved_masks(rng, children[0], N_SITES, 0.2)
    weights = torch.as_tensor(integer_weights(rng, N_SITES))
    leaves = torch.as_tensor(masks)
    trees = from_numpy(children, parents_of(children))
    for rates, freqs in ((None, None), tuple(torch.as_tensor(x) for x in GTR)):
        expected = []
        for b in range(children.shape[0]):
            topo = Topology(trees.children[b], trees.parents[b])
            lengths, _ = optimize_branch_lengths_newton(
                topo, leaves, 4, rates, freqs, weights, sequences_are_masks=True,
                n_sweeps=SWEEPS)
            expected.append(per_site_log_likelihood(
                topo, lengths, leaves, 4, rates, freqs, sequences_are_masks=True))
        expected = torch.stack(expected)
        for chunk in (7, 3):
            timings: dict = {}
            got = per_site_matrix(trees, leaves, 4, rates, freqs, weights, n_sweeps=SWEEPS,
                                  sequences_are_masks=True, chunk=chunk, timings=timings)
            assert timings["chunk"] == chunk and timings["chunks"] == -(-7 // chunk)
            torch.testing.assert_close(got, expected, rtol=1e-5, atol=0)


def test_per_site_rows_of_the_plain_kernel():
    """K3/K4's plain version with ``per_site=True``: the per-site rows of
    ``per_site_log_likelihood`` (unweighted) and the sums of the plain
    call, under one shared P and a P a branch; the wrapper hands CPU
    tensors to it."""
    rng = np.random.default_rng(6)
    children = random_children(rng, N_TAXA, 3)
    masks = torch.as_tensor(evolved_masks(rng, children[0], N_SITES, 0.2))
    weights = torch.as_tensor(integer_weights(rng, N_SITES))
    lengths = torch.as_tensor(rng.uniform(0.05, 0.3, (3, 2 * N_TAXA - 1)), dtype=torch.float32)
    from trex_tpu_torch.ops.likelihood import jc69_transition

    prior = torch.full((4,), 0.25)
    kids = torch.as_tensor(children)
    for transition in (jc69_transition(torch.tensor(0.1), 4), jc69_transition(lengths, 4)):
        sums = batched_log_likelihood_plain(kids, masks, weights, prior, transition,
                                            sequences_are_masks=True)
        got_sums, rows = batched_log_likelihood_cuda(kids, masks, weights, prior, transition,
                                                     sequences_are_masks=True, per_site=True)
        torch.testing.assert_close(got_sums, sums, rtol=0, atol=0)
        for b in range(3):
            blens = lengths[b] if transition.dim() == 4 else torch.full((2 * N_TAXA - 1,), 0.1)
            want = per_site_log_likelihood(
                Topology(kids[b], torch.as_tensor(parents_of(children[b]))), blens, masks, 4,
                sequences_are_masks=True)
            torch.testing.assert_close(rows[b], want, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close((rows * weights).sum(-1), sums, rtol=0, atol=0)


def test_branch_supports_need_draws(case):
    with pytest.raises(ValueError, match="replicate_weights or a generator"):
        alrt.branch_supports(_topology(case), torch.as_tensor(case["masks"]), 4,
                             n_sweeps=1, sequences_are_masks=True)
