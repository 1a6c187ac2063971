"""ctypes bindings for the port's native host library (counterpart of
``trex_tpu/io/native.py``).

The library is ``csrc/trex_native.cpp``: newick parsing and writing,
coalescent topology sampling and the NNI/SPR/TBR move generators, in C++.
It is built at first use with ``g++ -O2 -fPIC -std=c++17 -shared`` into
``build/trex_tpu_torch/libtrex_native-<digest>.so`` at the root of the
checkout (the digest covers the source and the flags), through a temporary
name unique to the process and an atomic rename, so processes building at
once leave one whole library and never write anywhere else. ``available()``
says whether it loaded; where it cannot be built, ``trex_tpu_torch.io``
runs the Python generators of ``io.fallback``, which share its contracts.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from functools import lru_cache
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "trex_native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "trex_tpu_torch"
CXX_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-shared")

BUILD_ERROR: list[str] = []
"""Why the library did not load, when it did not (one entry)."""


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libtrex_native-{digest[:16]}.so"


def build() -> Path:
    """Compile the library unless it is built; returns its path. Raises
    when ``g++`` is missing or fails."""
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH; the native library is built at first use")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
        capture_output=True, text=True,
    )
    if proc.returncode:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for {SOURCE.name}:\n{proc.stderr}")
    os.replace(tmp, out)
    return out


@lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL | None:
    """The loaded library, building it if needed; None if unavailable."""
    try:
        lib = ctypes.CDLL(str(build()))
    except (OSError, RuntimeError) as exc:
        BUILD_ERROR[:] = [str(exc)]
        return None

    i32p = ctypes.POINTER(ctypes.c_int32)
    f64p = ctypes.POINTER(ctypes.c_double)
    lib.trex_parse_newick.restype = ctypes.c_int
    lib.trex_parse_newick.argtypes = [
        ctypes.c_char_p, i32p, i32p, f64p, ctypes.c_char_p, ctypes.c_int, i32p,
    ]
    lib.trex_write_newick.restype = ctypes.c_int
    lib.trex_write_newick.argtypes = [
        i32p, ctypes.c_int, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int,
    ]
    lib.trex_sample_topologies.restype = None
    lib.trex_sample_topologies.argtypes = [
        ctypes.c_uint64, ctypes.c_int, ctypes.c_int, i32p, i32p,
    ]
    lib.trex_nni_count.restype = ctypes.c_int
    lib.trex_nni_count.argtypes = [i32p, ctypes.c_int]
    lib.trex_nni_neighbors.restype = ctypes.c_int
    lib.trex_nni_neighbors.argtypes = [i32p, ctypes.c_int, i32p, i32p]
    lib.trex_spr.restype = ctypes.c_int
    lib.trex_spr.argtypes = [
        i32p, ctypes.c_int, ctypes.c_int32, ctypes.c_int32, i32p, i32p,
    ]
    lib.trex_tbr.restype = ctypes.c_int
    lib.trex_tbr.argtypes = [
        i32p, ctypes.c_int, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, i32p, i32p,
    ]
    lib.trex_spr_neighborhood.restype = ctypes.c_int
    lib.trex_spr_neighborhood.argtypes = [i32p, ctypes.c_int, i32p, i32p, ctypes.c_int]
    lib.trex_tbr_neighborhood.restype = ctypes.c_int
    lib.trex_tbr_neighborhood.argtypes = [
        i32p, ctypes.c_int, ctypes.c_uint64, i32p, i32p, ctypes.c_int,
    ]
    return lib


def available() -> bool:
    """Whether the library is built and loaded (building it if needed)."""
    return load_library() is not None


def _lib() -> ctypes.CDLL:
    lib = load_library()
    if lib is None:
        raise RuntimeError(f"native library unavailable: {BUILD_ERROR[0]}")
    return lib


def _i32(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _host_children(children) -> np.ndarray:
    return np.ascontiguousarray(children, dtype=np.int32)


def parse_newick(text: str):
    """Parse a rooted binary newick string: (children (n_anc, 2) int32,
    parents (n_all,) int32, branch lengths (n_all,) float64 by child node,
    leaf names)."""
    lib = _lib()
    n_leaves_guess = text.count(",") + 1
    n_all = 2 * n_leaves_guess - 1
    children = np.zeros((max(n_leaves_guess - 1, 1), 2), dtype=np.int32)
    parents = np.zeros(max(n_all, 1), dtype=np.int32)
    blens = np.zeros(max(n_all, 1), dtype=np.float64)
    names_buf = ctypes.create_string_buffer(len(text) + n_all * 8 + 16)
    n_leaves_out = np.zeros(1, dtype=np.int32)
    rc = lib.trex_parse_newick(
        text.encode(), _i32(children), _i32(parents),
        blens.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        names_buf, len(names_buf), _i32(n_leaves_out),
    )
    if rc != 0:
        raise ValueError(f"newick parse failed (code {rc})")
    n_leaves = int(n_leaves_out[0])
    names = names_buf.value.decode().split("\n") if n_leaves else []
    return (
        children[: n_leaves - 1].copy(),
        parents[: 2 * n_leaves - 1].copy(),
        blens[: 2 * n_leaves - 1].copy(),
        names,
    )


def write_newick(children: np.ndarray, leaf_names: list[str] | None = None) -> str:
    lib = _lib()
    children = _host_children(children)
    n_leaves = children.shape[0] + 1
    names = "\n".join(leaf_names).encode() if leaf_names else None
    cap = 16 * (2 * n_leaves) + (len(names) if names else 8 * n_leaves) + 16
    out = ctypes.create_string_buffer(cap)
    rc = lib.trex_write_newick(_i32(children), n_leaves, names, out, cap)
    if rc < 0:
        raise ValueError(f"newick write failed (code {rc})")
    return out.value.decode()


def sample_topologies(seed: int, n_leaves: int, batch: int):
    """Batched coalescent topology sampling (canonical numbering)."""
    lib = _lib()
    children = np.zeros((batch, n_leaves - 1, 2), dtype=np.int32)
    parents = np.zeros((batch, 2 * n_leaves - 1), dtype=np.int32)
    lib.trex_sample_topologies(seed, n_leaves, batch, _i32(children), _i32(parents))
    return children, parents


def nni_neighbors(children: np.ndarray):
    """All NNI neighbors of a canonical topology."""
    lib = _lib()
    children = _host_children(children)
    n_leaves = children.shape[0] + 1
    count = lib.trex_nni_count(_i32(children), n_leaves)
    out_children = np.zeros((max(count, 1), n_leaves - 1, 2), dtype=np.int32)
    out_parents = np.zeros((max(count, 1), 2 * n_leaves - 1), dtype=np.int32)
    written = lib.trex_nni_neighbors(
        _i32(children), n_leaves, _i32(out_children), _i32(out_parents)
    )
    return out_children[:written].copy(), out_parents[:written].copy()


def _one_move(fn, children: np.ndarray, *nodes: int):
    # The library checks each node against the top of its range only: a
    # negative one would index out of bounds, so it is refused here.
    if min(nodes) < 0:
        return None
    children = _host_children(children)
    n_leaves = children.shape[0] + 1
    out_children = np.zeros((n_leaves - 1, 2), dtype=np.int32)
    out_parents = np.zeros(2 * n_leaves - 1, dtype=np.int32)
    rc = fn(_i32(children), n_leaves, *nodes, _i32(out_children), _i32(out_parents))
    return None if rc != 0 else (out_children, out_parents)


def spr_move(children: np.ndarray, prune_node: int, regraft_node: int):
    """One SPR move; (children, parents) or None if invalid."""
    return _one_move(_lib().trex_spr, children, prune_node, regraft_node)


def tbr_move(children: np.ndarray, prune_node: int, reroot_node: int, regraft_node: int):
    """One TBR move (prune + reroot + regraft); None if invalid."""
    return _one_move(_lib().trex_tbr, children, prune_node, reroot_node, regraft_node)


# Output buffers reused per shape: first-touch page faults on fresh large
# allocations would cost more than the enumeration itself.
_NEIGHBORHOOD_BUFFERS: dict[tuple, tuple[np.ndarray, np.ndarray]] = {}


def _buffers(key: tuple, cap: int, n_leaves: int):
    if key not in _NEIGHBORHOOD_BUFFERS:
        _NEIGHBORHOOD_BUFFERS[key] = (
            np.zeros((cap, n_leaves - 1, 2), dtype=np.int32),
            np.zeros((cap, 2 * n_leaves - 1), dtype=np.int32),
        )
    return _NEIGHBORHOOD_BUFFERS[key]


def spr_neighborhood(children: np.ndarray, max_trees: int | None = None):
    """Deduplicated SPR neighborhood in one native call, capped at
    ``max_trees`` (default 200,000 trees).

    Returns views into per-shape cached buffers (overwritten by the next
    call of the same shape); copy to keep them.
    """
    lib = _lib()
    children = _host_children(children)
    n_leaves = children.shape[0] + 1
    n_all = 2 * n_leaves - 1
    cap = min((n_all - 1) * (n_all - 1), max_trees if max_trees is not None else 200_000)
    out_children, out_parents = _buffers((cap, n_leaves), cap, n_leaves)
    count = lib.trex_spr_neighborhood(
        _i32(children), n_leaves, _i32(out_children), _i32(out_parents), cap
    )
    if count < 0:
        raise RuntimeError(f"spr_neighborhood failed (code {count})")
    return out_children[:count], out_parents[:count]


def tbr_neighborhood(children: np.ndarray, max_trees: int = 16384, seed: int = 0):
    """Deduplicated TBR neighborhood (SPR included) in one native call.

    The (prune, regraft) iteration order is shuffled by ``seed``, so a set
    truncated at ``max_trees`` is an unbiased sample. Returns views into
    per-shape cached buffers; copy to keep them.
    """
    lib = _lib()
    children = _host_children(children)
    n_leaves = children.shape[0] + 1
    cap = min(max_trees, 200_000)
    out_children, out_parents = _buffers((cap, n_leaves, "tbr"), cap, n_leaves)
    count = lib.trex_tbr_neighborhood(
        _i32(children), n_leaves, ctypes.c_uint64(seed),
        _i32(out_children), _i32(out_parents), cap,
    )
    if count < 0:
        raise RuntimeError(f"tbr_neighborhood failed (code {count})")
    return out_children[:count], out_parents[:count]
