"""The last small functions of the JAX package's layers, each against its
JAX namesake: ``io`` (``parse_fasta``, ``encode_alignment``,
``write_phylip``, ``nni_neighbors``), ``alignment`` (the constant and
parsimony-informative site masks), ``ops.fitch.leaf_masks``,
``search.hillclimb.batched_random_restarts`` (seed = the last word of the
JAX key), ``types.default_dtype``/``set_default_dtype``,
``utils.chunking.chunked_map`` (``jax.lax.map``), ``utils.profiling``
(``Timer``, ``profile_trace``) and ``utils.debug.enable_nan_checks``."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import jitted_jax_scores, parents_of, random_children

import trex_tpu.alignment as jax_alignment
import trex_tpu.io as jax_io
import trex_tpu.types as jax_types
from trex_tpu.ops.fitch import leaf_masks as jax_leaf_masks
from trex_tpu.search.hillclimb import batched_random_restarts as jax_restarts
from trex_tpu.topology import Topology as JaxTopology
from trex_tpu.utils.chunking import chunked_map as jax_chunked_map
from trex_tpu_torch import alignment, io, types
from trex_tpu_torch.ops.fitch import leaf_masks
from trex_tpu_torch.search.hillclimb import batched_random_restarts
from trex_tpu_torch.topology import from_numpy
from trex_tpu_torch.utils import debug, profiling
from trex_tpu_torch.utils.chunking import chunked_map

FASTA = ">a\nACGT-N\n>b longer name\nacgtRA\n>c\nTTGG?C\n"


def test_io_leftovers_equal_jax():
    for alphabet in (io.DNA, io.PROTEIN):
        names, states = io.parse_fasta(FASTA, alphabet)
        ref_names, ref_states = jax_io.parse_fasta(FASTA, alphabet)
        assert names == ref_names
        np.testing.assert_array_equal(states, ref_states)
        assert states.dtype == ref_states.dtype
    rows = np.frombuffer(b"ACGTNacgt-", dtype=np.uint8).reshape(2, 5)
    np.testing.assert_array_equal(io.encode_alignment(rows, io.DNA),
                                  jax_io.formats.encode_alignment(rows, jax_io.DNA))
    assert io.write_phylip(["a", "bbb"], rows) == jax_io.formats.write_phylip(["a", "bbb"], rows)
    names, parsed = io.parse_phylip(io.write_phylip(["a", "bbb"], rows))
    assert names == ["a", "bbb"] and np.array_equal(parsed, rows)
    children = random_children(np.random.default_rng(1), 9, 1)[0]
    nbrs = io.nni_neighbors(from_numpy(children, parents_of(children)))
    ref = jax_io.nni_neighbors(JaxTopology(jnp.asarray(children),
                                           jnp.asarray(parents_of(children))))
    np.testing.assert_array_equal(nbrs.children.numpy(), np.asarray(ref.children))
    np.testing.assert_array_equal(nbrs.parents.numpy(), np.asarray(ref.parents))


def test_site_masks_and_leaf_masks_equal_jax():
    rng = np.random.default_rng(2)
    seqs = rng.integers(0, 4, (7, 50)).astype(np.int32)
    seqs[:, :5] = seqs[0, :5]  # constant columns
    seqs[:, 5:8] = 0
    seqs[0, 5:8] = 1  # a singleton: variable, not informative
    np.testing.assert_array_equal(alignment.constant_site_mask(seqs),
                                  jax_alignment.constant_site_mask(seqs))
    np.testing.assert_array_equal(alignment.parsimony_informative_mask(seqs),
                                  jax_alignment.parsimony_informative_mask(seqs))
    assert alignment.constant_site_mask(seqs)[:5].all()
    assert not alignment.parsimony_informative_mask(seqs)[:8].any()
    masks = leaf_masks(torch.as_tensor(seqs))
    assert masks.dtype == torch.int32
    np.testing.assert_array_equal(masks.numpy(), np.asarray(jax_leaf_masks(jnp.asarray(seqs))))


def test_batched_random_restarts_equals_jax(monkeypatch):
    jitted_jax_scores(monkeypatch)
    rng = np.random.default_rng(3)
    seqs = rng.integers(0, 4, (8, 40)).astype(np.int32)
    cost = np.ones((4, 4), np.float32) - np.eye(4, dtype=np.float32)
    want = jax_restarts(jax.random.PRNGKey(11), 8, jnp.asarray(cost), jnp.asarray(seqs),
                        n_starts=3, max_rounds=5)
    got = batched_random_restarts(11, 8, torch.as_tensor(cost), torch.as_tensor(seqs),
                                  n_starts=3, max_rounds=5)
    np.testing.assert_array_equal(got.topology.children.numpy(),
                                  np.asarray(want.topology.children))
    assert got.score == float(want.score) and got.rounds == int(want.rounds)


def test_default_dtype():
    assert types.default_dtype() == torch.float32
    assert jnp.dtype(jax_types.default_dtype()) == jnp.float32
    assert types.CostModel.hamming(4).matrix.dtype == torch.float32
    types.set_default_dtype(torch.float64)
    try:
        assert types.default_dtype() == torch.float64
        assert types.CostModel.hamming(4).matrix.dtype == torch.float64
    finally:
        types.set_default_dtype(torch.float32)
    with pytest.raises(TypeError):
        types.set_default_dtype(torch.int32)


@pytest.mark.parametrize("batch_size", [None, 3])
def test_chunked_map_equals_lax_map(batch_size):
    xs = np.random.default_rng(4).random((7, 5)).astype(np.float32)
    ys = np.arange(7, dtype=np.float32)
    fn = lambda x, y: (x * y).sum() + x.max()  # noqa: E731
    want = jax_chunked_map(lambda a: fn(*a), (jnp.asarray(xs), jnp.asarray(ys)),
                           batch_size=batch_size)
    got = chunked_map(fn, (torch.as_tensor(xs), torch.as_tensor(ys)), batch_size=batch_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    pair = chunked_map(lambda x: (x.sum(), x * 2), torch.as_tensor(xs), batch_size=batch_size)
    np.testing.assert_allclose(pair[1].numpy(), xs * 2)
    np.testing.assert_allclose(pair[0].numpy(), xs.sum(axis=1), rtol=1e-6)


def test_profiling_and_debug(tmp_path):
    timer = profiling.Timer()
    for _ in range(2):
        with timer.time(torch.ones(3)):
            pass
    assert timer.count == 2 and timer.mean >= 0.0 and timer.total >= timer.mean
    with profiling.profile_trace(str(tmp_path / "trace")):
        torch.ones(8).cumsum(0)
    with open(os.path.join(tmp_path, "trace", "trace.json")) as fh:
        assert "traceEvents" in json.load(fh)
    debug.enable_nan_checks(True)
    try:
        assert torch.is_anomaly_enabled()
        x = torch.tensor([-1.0], requires_grad=True)
        # The anomaly mode names the forward call that made the NaN.
        with pytest.raises(RuntimeError, match="nan"), pytest.warns(UserWarning, match="Sqrt"):
            (torch.sqrt(x) * 0).sum().backward()
    finally:
        debug.enable_nan_checks(False)
    assert not torch.is_anomaly_enabled()
