"""The port's mesh in one process: ``make_mesh``'s shapes against the JAX
package's over 1, 2, 4 and 8 of the conftest's virtual devices,
``initialize_distributed`` without a world, the CLI's ``--mesh`` rules
(``_make_cli_mesh``) against the JAX CLI's, and the sharded functions on a
1 x 1 mesh without a process group (the identity collectives) against the
single-device functions."""

import jax
import numpy as np
import pytest
import torch
from _torch_parity import evolved_masks, integer_weights, parents_of, random_children

import trex_tpu.cli._common as jax_common
import trex_tpu.parallel.mesh as jax_mesh
import trex_tpu_torch.cli._common as torch_common
import trex_tpu_torch.parallel.mesh as torch_mesh
from trex_tpu_torch.ops.dispatch import batched_scores_fastest
from trex_tpu_torch.ops.likelihood import jc69_transition
from trex_tpu_torch.ops.likelihood_asr import per_site_matrix
from trex_tpu_torch.ops.likelihood_cuda import batched_log_likelihood_cuda
from trex_tpu_torch.ops.spr_scan import spr_scan, spr_scan_best_segmented
from trex_tpu_torch.parallel import initialize_distributed, make_mesh, sharded
from trex_tpu_torch.topology import Topology
from trex_tpu_torch.types import CostModel


@pytest.mark.parametrize("n, tree_parallelism", [
    (1, None), (2, None), (4, None), (8, None), (1, 1), (2, 2), (4, 1), (8, 2), (8, 8),
])
def test_mesh_shape_matches_jax(n, tree_parallelism):
    want = jax_mesh.make_mesh(jax.devices()[:n], tree_parallelism=tree_parallelism)
    got = make_mesh(world_size=n, tree_parallelism=tree_parallelism)
    assert got.shape == dict(want.shape)
    assert (got.tree_index, got.site_index) == (0, 0)


def test_mesh_shape_refuses_what_jax_refuses():
    for model in (lambda: jax_mesh.make_mesh(jax.devices()[:6], tree_parallelism=4),
                  lambda: make_mesh(world_size=6, tree_parallelism=4)):
        with pytest.raises(ValueError, match="not divisible"):
            model()


def test_no_world_without_a_launcher(monkeypatch):
    for name in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "LOCAL_RANK"):
        monkeypatch.delenv(name, raising=False)
    assert initialize_distributed(device="cpu") is False
    assert not torch.distributed.is_initialized()


def test_collectives_over_ranks_not_joined_raise():
    mesh = make_mesh(world_size=2, tree_parallelism=2)
    with pytest.raises(RuntimeError, match="not joined"):
        mesh.psum(torch.ones(2), "tree")
    assert mesh.psum(torch.ones(2), "site").tolist() == [1.0, 1.0]


@pytest.fixture
def eight_ranks(monkeypatch):
    """A world of eight ranks as far as ``_make_cli_mesh`` can see (its
    meshes are shapes only), beside the conftest's eight JAX devices."""
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda group=None: 8)
    monkeypatch.setattr(torch_mesh, "make_mesh", lambda world_size=None, tree_parallelism=None:
                        torch_mesh.mesh_shape(8, tree_parallelism))


@pytest.mark.parametrize("spec, divides", [
    (None, None), ("auto", None), ("auto", 6), ("auto", 4), ("auto", 3), ("2,4", None),
    ("4,2", None), ("8,1", None), ("1,8", None), ("1,1", None),
])
def test_cli_mesh_rules_match_jax(eight_ranks, spec, divides):
    want = jax_common._make_cli_mesh(spec, divides)
    got = torch_common._make_cli_mesh(spec, divides)
    if want is None:
        assert got is None
    else:
        assert got == (want.shape["tree"], want.shape["site"])


@pytest.mark.parametrize("spec", ["3,3", "2,2", "x", "2"])
def test_cli_mesh_refusals_match_jax(eight_ranks, spec):
    with pytest.raises(SystemExit) as want:
        jax_common._make_cli_mesh(spec)
    with pytest.raises(SystemExit) as got:
        torch_common._make_cli_mesh(spec)
    assert str(got.value) == str(want.value)


def test_cli_mesh_in_one_process():
    assert torch_common._make_cli_mesh(None) is None
    assert torch_common._make_cli_mesh("1,1") is None
    assert torch_common._make_cli_mesh("auto").shape == {"tree": 1, "site": 1}
    with pytest.raises(SystemExit, match=r"--mesh 2,1: 2\*1 != 1 addressable devices"):
        torch_common._make_cli_mesh("2,1")


def test_one_by_one_mesh_runs_the_sharded_functions():
    """No process group: every sharded function is its single-device one."""
    rng = np.random.default_rng(3)
    mesh = make_mesh()
    assert mesh.groups == {"tree": None, "site": None}
    children = random_children(rng, 8, 5)
    batch = Topology(torch.as_tensor(children), torch.as_tensor(parents_of(children)))
    masks = torch.as_tensor(evolved_masks(rng, children[0], 37, 0.3))
    w = torch.as_tensor(integer_weights(rng, 37))
    for cost in (CostModel.hamming(4).matrix, CostModel.transition_transversion(1.0, 2.0).matrix):
        want = batched_scores_fastest(batch, cost, masks, w, sequences_are_masks=True)
        got = sharded.sharded_batch_scores(mesh, batch, cost, masks, site_weights=w,
                                           sequences_are_masks=True)
        assert torch.equal(got, want)
        idx, score = sharded.sharded_best_tree(mesh, batch, cost, masks, site_weights=w,
                                               sequences_are_masks=True)
        assert int(idx) == int(torch.argmin(want)) and float(score) == float(want.min())
    blens = torch.full((5, 15), 0.1)
    want = batched_log_likelihood_cuda(batch.children, masks, w, torch.full((4,), 0.25),
                                       jc69_transition(blens, 4), sequences_are_masks=True)
    got = sharded.sharded_log_likelihoods(mesh, batch, blens, masks, 4, site_weights=w,
                                          sequences_are_masks=True)
    assert torch.equal(got, want)
    assert torch.equal(
        sharded.sharded_per_site_matrix(mesh, batch, masks, 4, weights=w, n_sweeps=2,
                                        sequences_are_masks=True),
        per_site_matrix(batch, masks, 4, weights=w, n_sweeps=2, sequences_are_masks=True))
    tree = Topology(batch.children[0], batch.parents[0])
    table, base = sharded.sharded_spr_scan(mesh, tree, masks, w, sequences_are_masks=True)
    want_table, want_base = spr_scan(tree, masks, w, sequences_are_masks=True)
    assert torch.equal(table, want_table) and float(base) == float(want_base)
    assert sharded.sharded_spr_scan_best(mesh, tree, masks, w, sequences_are_masks=True) == \
        spr_scan_best_segmented(tree, masks, w, sequences_are_masks=True)
