"""``trex_tpu_torch.parallel.sharded`` on two CPU ranks (gloo), on the (2, 1)
and (1, 2) meshes of one world, against the JAX package's single-device
functions on the same numpy inputs: batch scores under Hamming and TT(1, 2)
costs, on states and masks, with weights and L = 45 (not a multiple of 2)
bit for bit; the best tree of a batch with a planted tie at JAX's index;
JC log-likelihoods and per-site rows within rtol 2e-5; the parsimony and ML
scan tables, whole and in several segments (bit for bit; rtol 2e-5); and
the scans' best moves as ``np.argmin`` of the tables (also on a constant
alignment, where every valid move ties)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from _torch_dist import MESHES, start_ranks
from _torch_parity import (
    evolved_masks,
    integer_weights,
    parents_of,
    random_children,
    random_masks,
)

from trex_tpu.ops.fitch import fitch_score
from trex_tpu.ops.likelihood import per_site_log_likelihood, tree_log_likelihood
from trex_tpu.ops.likelihood_asr import optimize_branch_lengths_newton
from trex_tpu.ops.likelihood_scan import likelihood_spr_scan
from trex_tpu.ops.sankoff import sankoff_score
from trex_tpu.ops.spr_scan import spr_scan
from trex_tpu.topology import Topology as JaxTopology
from trex_tpu.types import CostModel

N_TAXA, N_SITES, BATCH = 8, 45, 7


def _jax_batch(children):
    return JaxTopology(jnp.asarray(children), jnp.asarray(parents_of(children)))


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    rng = np.random.default_rng(12)
    children = random_children(rng, N_TAXA, BATCH)
    truth = random_children(rng, N_TAXA, 1)[0]
    masks = evolved_masks(rng, truth, N_SITES, 0.25)
    masks[rng.random(masks.shape) < 0.08] = 5  # ambiguous A/G
    states = rng.integers(0, 4, (N_TAXA, N_SITES)).astype(np.int32)
    weights = integer_weights(rng, N_SITES)
    tt = np.asarray(CostModel.transition_transversion(1.0, 2.0).matrix, np.float32)
    # The tie: the batch's best tree again at index 4, so both (2, 1) ranks
    # (blocks 0-2 and 3-5) hold a minimum; JAX's argmin is the first.
    tie = random_children(rng, N_TAXA, 6)
    hamming = CostModel.hamming(4).matrix
    tie_scores = np.asarray(jax.vmap(lambda t: sankoff_score(t, hamming, jnp.asarray(states)))(
        _jax_batch(tie)))
    tie[4] = tie[int(tie_scores.argmin())]
    blens = rng.uniform(0.05, 0.4, (BATCH, 2 * N_TAXA - 1)).astype(np.float32)
    ps_children = random_children(rng, N_TAXA, 3)
    inputs = dict(children=children, parents=parents_of(children), states=states, masks=masks,
                  weights=weights, tt=tt, tie_children=tie, tie_parents=parents_of(tie),
                  blens=blens, ps_children=ps_children, ps_parents=parents_of(ps_children),
                  ps_weights=weights, scan_children=truth, scan_parents=parents_of(truth),
                  const_masks=np.ones((N_TAXA, N_SITES), np.int32))
    ranks = start_ranks(tmp_path_factory.mktemp("sharded"), "sharded", inputs)
    want = _oracle(inputs, tie_scores)
    return inputs, want, ranks.wait()


def _oracle(inputs, tie_scores):
    """The JAX package's single-device values of every quantity."""
    topos = _jax_batch(inputs["children"])
    w = jnp.asarray(inputs["weights"])
    states, masks = jnp.asarray(inputs["states"]), jnp.asarray(inputs["masks"])
    tt, hamming = jnp.asarray(inputs["tt"]), CostModel.hamming(4).matrix

    def batch(fn):
        return np.asarray(jax.jit(jax.vmap(fn))(topos))

    scan_tree = JaxTopology(jnp.asarray(inputs["scan_children"]),
                            jnp.asarray(inputs["scan_parents"]))

    @jax.jit
    def fit_rows(topo):
        lengths, _ = optimize_branch_lengths_newton(
            topo, masks, 4, None, None, jnp.asarray(inputs["ps_weights"]),
            sequences_are_masks=True, n_sweeps=3)
        return per_site_log_likelihood(topo, lengths, masks, 4, sequences_are_masks=True)

    ps = _jax_batch(inputs["ps_children"])
    scan, base = spr_scan(scan_tree, masks, w, sequences_are_masks=True)
    ml_scan, ml_base = likelihood_spr_scan(scan_tree, masks, 4, 0.1, w,
                                           sequences_are_masks=True)
    const_scan, _ = spr_scan(scan_tree, jnp.asarray(inputs["const_masks"]),
                             sequences_are_masks=True)
    return dict(
        fitch=batch(lambda t: fitch_score(t, states, w)),
        fitch_masks=batch(lambda t: fitch_score(t, masks, w, sequences_are_masks=True)),
        sankoff=batch(lambda t: sankoff_score(t, tt, states, w)),
        sankoff_masks=batch(lambda t: sankoff_score(t, tt, masks, w, sequences_are_masks=True)),
        sankoff_forced=batch(lambda t: sankoff_score(t, hamming, states, w)),
        tie=tie_scores,
        lnl=np.asarray(jax.vmap(lambda t, b: tree_log_likelihood(
            t, b, masks, 4, site_mask=w, sequences_are_masks=True))(
                topos, jnp.asarray(inputs["blens"]))),
        per_site=np.stack([np.asarray(fit_rows(jax.tree_util.tree_map(lambda x: x[i], ps)))
                           for i in range(ps.children.shape[0])]),
        scan=np.asarray(scan), base=float(base), ml_scan=np.asarray(ml_scan),
        ml_base=float(ml_base), const_scan=np.asarray(const_scan),
    )


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("key", ["fitch", "fitch_masks", "sankoff", "sankoff_masks",
                                 "sankoff_forced"])
def test_batch_scores_bit_equal_jax(case, mesh, key):
    _, want, outs = case
    for out in outs:
        np.testing.assert_array_equal(out[f"{mesh}_{key}"], want[key])


@pytest.mark.parametrize("mesh", MESHES)
def test_best_tree_breaks_the_tie_as_jax(case, mesh):
    _, want, outs = case
    assert (want["tie"] == want["tie"].min()).sum() >= 2
    for out in outs:
        idx, score = out[f"{mesh}_best"]
        assert int(idx) == int(np.argmin(want["tie"])) and score == want["tie"].min()


@pytest.mark.parametrize("mesh", MESHES)
def test_log_likelihoods_and_rows_match_jax(case, mesh):
    _, want, outs = case
    for out in outs:
        np.testing.assert_allclose(out[f"{mesh}_lnl"], want["lnl"], rtol=2e-5)
        np.testing.assert_allclose(out[f"{mesh}_per_site"], want["per_site"], rtol=2e-5,
                                   atol=1e-4)
    np.testing.assert_array_equal(outs[0][f"{mesh}_per_site"], outs[1][f"{mesh}_per_site"])


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("tag", ["", "_seg"])
def test_scan_tables_match_jax(case, mesh, tag):
    _, want, outs = case
    for out in outs:
        np.testing.assert_array_equal(out[f"{mesh}_scan{tag}"], want["scan"])
        assert float(out[f"{mesh}_scan{tag}_base"]) == want["base"]
        np.testing.assert_allclose(out[f"{mesh}_ml_scan{tag}"], want["ml_scan"], rtol=2e-5)
        np.testing.assert_allclose(float(out[f"{mesh}_ml_scan{tag}_base"]), want["ml_base"],
                                   rtol=2e-5)


def _argmin_move(table):
    flat = int(np.argmin(table))
    p, v = divmod(flat, table.shape[-1])
    return table[p, v], p, v


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("tag", ["", "_seg"])
def test_scan_best_is_argmin_of_the_table(case, mesh, tag):
    _, want, outs = case
    n_all = want["scan"].shape[-1]
    best, p, v = _argmin_move(want["scan"])
    # Ties: several moves share the parsimony minimum, in both ranks' rows.
    tied = np.argwhere(want["scan"] == best)
    assert len(tied) > 1 and tied[:, 0].min() < n_all // 2 <= tied[:, 0].max()
    for out in outs:
        got = out[f"{mesh}_best_pars{tag}"]
        assert tuple(got) == (best, p, v, want["base"], np.isfinite(want["scan"]).sum())
        ml = out[f"{mesh}_best_ml{tag}"]
        table = out[f"{mesh}_ml_scan{tag}"]
        assert tuple(ml[:3]) == _argmin_move(table)
        assert ml[4] == np.isfinite(table).sum()
        # The port's move is JAX's unless the two best lie within rtol.
        ml_best, ml_p, ml_v = _argmin_move(want["ml_scan"])
        second = np.partition(want["ml_scan"].ravel(), 1)[1]
        if second - ml_best > 2e-5 * abs(ml_best):
            assert (int(ml[1]), int(ml[2])) == (ml_p, ml_v)


@pytest.mark.parametrize("mesh", MESHES)
def test_scan_best_on_an_all_tied_table(case, mesh):
    """A constant alignment: every valid move scores the base; the move is
    the table's first valid entry, whichever rank's rows hold it."""
    _, want, outs = case
    best, p, v = _argmin_move(want["const_scan"])
    assert (want["const_scan"] == best).sum() == np.isfinite(want["const_scan"]).sum()
    for out in outs:
        got = out[f"{mesh}_best_const"]
        assert tuple(got[:3]) == (best, p, v)
