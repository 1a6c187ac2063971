"""The port's native host library (``trex_tpu_torch/io/native.py``, built
from ``trex_tpu_torch/csrc/trex_native.cpp``): where it is built, that
concurrent builds leave one library, its generators against the port's
Python fallback move for move, and its sampler and truncated TBR against
the JAX package's native output."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from _torch_parity import parents_of, random_children

import trex_tpu_torch.io as tio
from trex_tpu_torch.io import fallback, native
from trex_tpu_torch.topology import from_numpy

REPO = Path(__file__).resolve().parents[1]
SIZES = (5, 8, 10)


def _listing(directory: Path) -> dict[str, int]:
    return {p.name: p.stat().st_mtime_ns for p in sorted(directory.iterdir())}


def _tree(n_leaves: int, seed: int = 0) -> np.ndarray:
    return fallback._canonicalize(
        n_leaves,
        {n_leaves + a: [int(c) for c in pair]
         for a, pair in enumerate(random_children(np.random.default_rng(seed), n_leaves, 1)[0])},
        2 * n_leaves - 2,
    )[0]


def test_builds_into_build_dir_and_never_under_native():
    before = _listing(REPO / "native")
    assert native.available(), native.BUILD_ERROR
    path = native.library_path()
    assert path.parent == REPO / "build" / "trex_tpu_torch"
    assert path.name.startswith("libtrex_native-") and path.exists()
    assert native.SOURCE == REPO / "trex_tpu_torch" / "csrc" / "trex_native.cpp"
    assert native.SOURCE.read_bytes() == (REPO / "native" / "trex_native.cpp").read_bytes()
    assert _listing(REPO / "native") == before


def test_three_concurrent_builds_leave_one_loadable_library(tmp_path):
    before = _listing(REPO / "native")
    # The module alone (no torch import), its build directory redirected.
    code = (
        "import ctypes, importlib.util, sys\n"
        "from pathlib import Path\n"
        "spec = importlib.util.spec_from_file_location('native', sys.argv[2])\n"
        "native = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(native)\n"
        "native.BUILD_DIR = Path(sys.argv[1])\n"
        "ctypes.CDLL(str(native.build()))\n"
    )
    args = [str(tmp_path), native.__file__]
    procs = [
        subprocess.Popen([sys.executable, "-c", code, *args], cwd=REPO)
        for _ in range(3)
    ]
    assert [p.wait(timeout=120) for p in procs] == [0, 0, 0]
    built = sorted(os.listdir(tmp_path))
    assert built == [native.library_path().name]
    assert _listing(REPO / "native") == before


@pytest.mark.parametrize("n_leaves", SIZES)
def test_generators_equal_the_python_fallback(n_leaves):
    children = _tree(n_leaves, n_leaves)
    for got, want in (
        (native.nni_neighbors(children), fallback.py_nni_neighbors(children)),
        (native.spr_neighborhood(children), fallback.py_spr_neighborhood(children)),
    ):
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    # Untruncated TBR: the same set (the two shuffle streams differ).
    got = native.tbr_neighborhood(children, max_trees=200_000, seed=3)
    want = fallback.py_tbr_neighborhood(children, max_trees=200_000, seed=3)
    assert got[0].shape == want[0].shape
    assert sorted(c.tobytes() for c in got[0]) == sorted(c.tobytes() for c in want[0])
    n_all = 2 * n_leaves - 1
    for prune in range(-1, n_all + 1):
        for regraft in range(-1, n_all + 1):
            a = native.spr_move(children, prune, regraft)
            b = fallback.py_spr_move(children, prune, regraft)
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a[0], b[0])
                np.testing.assert_array_equal(a[1], b[1])
            for reroot in range(n_all):
                a = native.tbr_move(children, prune, reroot, regraft)
                b = fallback.py_tbr_move(children, prune, reroot, regraft)
                assert (a is None) == (b is None)
                if a is not None:
                    np.testing.assert_array_equal(a[0], b[0])
                    np.testing.assert_array_equal(a[1], b[1])


def test_newick_parse_and_write_equal_the_python_fallback():
    children = _tree(10, 4)
    names = [f"t{i}" for i in range(10)]
    assert native.write_newick(children, names) == fallback.py_write_newick(children, names)
    assert native.write_newick(children) == fallback.py_write_newick(children)
    text = "((a:0.5,(b:1,c:2.25)x:0.1):3,(d,e:7)):0;"
    for got, want in zip(native.parse_newick(text), fallback.py_parse_newick(text)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_io_falls_back_to_python_with_the_same_output(monkeypatch):
    topo = from_numpy(_tree(9, 7), parents_of(_tree(9, 7)))
    with_lib = [np.copy(x) for x in tio.spr_neighborhood_host(topo)]
    nni_lib = tio.nni_neighbors_host(topo)
    monkeypatch.setattr(native, "available", lambda: False)
    for got, want in zip(tio.spr_neighborhood_host(topo), with_lib):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(tio.nni_neighbors_host(topo), nni_lib):
        np.testing.assert_array_equal(got, want)
    assert tio.spr_move(topo, 0, 5) is not None
    assert tio.save_newick(topo) == fallback.py_write_newick(topo.to_numpy()[0])


@pytest.mark.parametrize("move", ["spr", "tbr"])
def test_device_neighborhoods_keep_their_trees_across_calls(move):
    # Two trees of one size: the native generators reuse one output buffer
    # per shape, so the first batch must not change under the second call.
    generate = {"spr": tio.spr_neighborhood,
                "tbr": lambda t: tio.tbr_neighborhood(t, max_trees=64, seed=1)}[move]
    first, second = _tree(9, 1), _tree(9, 2)
    assert not np.array_equal(first, second)
    batch = generate(from_numpy(first, parents_of(first)))
    kept = (batch.children.clone(), batch.parents.clone())
    generate(from_numpy(second, parents_of(second)))
    assert torch.equal(batch.children, kept[0]) and torch.equal(batch.parents, kept[1])


@pytest.fixture
def jax_native(monkeypatch):
    """The JAX package's native binding, loaded from the port's build of the
    byte-identical source (``test_native_source_is_a_byte_copy``), so the
    test runs on a fresh checkout without a build under ``native/`` and
    without editing a JAX file."""
    from trex_tpu.io import native as jax_native

    try:
        path = str(native.build())
    except RuntimeError as exc:  # no g++: neither library can be built
        pytest.skip(str(exc))
    monkeypatch.setattr(jax_native, "_LIB_PATH", path)
    jax_native.load_library.cache_clear()
    yield jax_native
    jax_native.load_library.cache_clear()


def test_sampler_and_truncated_tbr_equal_the_jax_package(jax_native):
    import trex_tpu.io as jax_io
    from trex_tpu.topology import Topology as JaxTopology

    for n_leaves, seed in ((6, 0), (10, 11)):
        ours = tio.sample_topologies(seed, n_leaves, 4, device="cpu")
        want = jax_io.sample_topologies(seed, n_leaves, 4)
        np.testing.assert_array_equal(ours.children.numpy(), np.asarray(want.children))
        np.testing.assert_array_equal(ours.parents.numpy(), np.asarray(want.parents))
    children = _tree(10, 1)
    parents = parents_of(children)
    jax_topo = JaxTopology(children=children, parents=parents)
    for budget, seed in ((50, 0), (300, 9)):
        got = tio.tbr_neighborhood_host(from_numpy(children, parents), max_trees=budget,
                                        seed=seed)
        want = jax_io.tbr_neighborhood_host(jax_topo, max_trees=budget, seed=seed)
        assert jax_native.available()
        np.testing.assert_array_equal(got[0], np.asarray(want[0]))
        np.testing.assert_array_equal(got[1], np.asarray(want[1]))
