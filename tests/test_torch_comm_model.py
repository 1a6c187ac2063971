"""The port's copy of the collective-volume model
(``trex_tpu_torch/parallel/comm_model.py``) against the JAX package's:
every public function returns the same values over a grid of mesh shapes
and sizes that holds the values of ``tests/test_comm_model.py``."""

import dataclasses
import itertools

import pytest

import trex_tpu.parallel.comm_model as jax_model
import trex_tpu_torch.parallel.comm_model as torch_model

MESH_SHAPES = [{"tree": t, "site": s} for t, s in
               [(1, 1), (1, 8), (2, 1), (2, 4), (4, 2), (8, 1), (3, 5)]]


def _same(got, want):
    """Collectives compared field by field (the two packages' classes differ)."""
    if isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    elif dataclasses.is_dataclass(want):
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.wire_bytes_per_device == want.wire_bytes_per_device
    else:
        assert got == want


def test_same_public_names():
    public = {n for n in dir(jax_model) if not n.startswith("_")} - {"annotations"}
    assert public <= set(dir(torch_model))


@pytest.mark.parametrize("shape", MESH_SHAPES, ids=lambda s: f"{s['tree']}x{s['site']}")
def test_collectives_match_jax(shape):
    for batch, dtype_bytes in itertools.product((1, 16, 64, 1024), (2, 4)):
        for name in ("batch_scoring_collectives", "best_tree_collectives"):
            _same(getattr(torch_model, name)(shape, batch, dtype_bytes),
                  getattr(jax_model, name)(shape, batch, dtype_bytes))
        _same(torch_model.shard_sizes(shape, batch, 8, 16 * shape["site"]),
              jax_model.shard_sizes(shape, batch, 8, 16 * shape["site"]))
    for n_restarts, n_all, n_anc in ((4, 7, 3), (8, 127, 63)):
        _same(torch_model.joint_step_collectives(shape, n_restarts, n_all, n_anc),
              jax_model.joint_step_collectives(shape, n_restarts, n_all, n_anc))
    for n_all in (7, 127, 1023):
        _same(torch_model.spr_scan_collectives(shape, n_all),
              jax_model.spr_scan_collectives(shape, n_all))
    for n_cand, length in ((10, 256), (1, 3), (33, 2048)):
        _same(torch_model.per_site_matrix_collectives(shape, n_cand, length),
              jax_model.per_site_matrix_collectives(shape, n_cand, length))
    _same(torch_model.stepping_stone_collectives(shape, 8, 100),
          jax_model.stepping_stone_collectives(shape, 8, 100))
    for runs, chains, moves, model in itertools.product((1, 2), (1, 4), (0, 2), (False, True)):
        _same(torch_model.mcmc_generation_collectives(shape, runs, chains, 63, 127, moves, model),
              jax_model.mcmc_generation_collectives(shape, runs, chains, 63, 127, moves, model))


@pytest.mark.parametrize("op, k, payload", [
    ("psum", 4, 1024), ("all_gather", 8, 32), ("psum", 1, 1 << 20), ("permute", 4, 999),
    ("all_gather", 3, 100),
])
def test_wire_bytes_and_efficiency_match_jax(op, k, payload):
    got = torch_model.Collective(op, "site", k, payload)
    want = jax_model.Collective(op, "site", k, payload)
    _same(got, want)
    for compute, link in ((1e-3, 1e18), (1e-6, 1e3), (1e-3, 1e9), (5e-4, 4.5e11)):
        assert torch_model.predicted_efficiency([got], compute, link) == \
            jax_model.predicted_efficiency([want], compute, link)


def test_unknown_op_raises_as_jax():
    for model in (torch_model, jax_model):
        with pytest.raises(ValueError):
            model.Collective("scatter", "tree", 2, 8).wire_bytes_per_device
