#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``trex_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout

Builds the six CUDA kernel libraries from ``trex_tpu_torch/csrc`` (one
``nvcc`` per source, in parallel), holds each against its plain PyTorch
version on the card at its paths' shapes (the parsimony kernels K1, K2, K5
and K6 bit for bit, since their scores are integer-valued; the likelihood
kernel within rtol 1e-5 of |lnL|; K1 at nine shapes (a)-(i), (i) an
8192-taxon tree in its global mode, and K2 at five real stepwise
insertions and on a 10,000-taxon tree, each with its launch plan), times
them, then runs the port's routes on simulated alignments, each with every
launch count set to 0 just before it and read just after:

- the default ``infer`` (stepwise addition, best of 4 orders, then
  SPR-scan climb) on 512 taxa x 2048 sites — the insertion kernel (K2) at
  every stepwise step, the Fitch kernel (K1) for each order's exact
  rescoring;
- the NNI route (``--neighborhood nni --rounds 20``) on 128 x 1024,
  whose candidate batches K1 scores;
- the ML NNI route (``--criterion ml --neighborhood nni --rounds 10``) on
  the main path's 512 x 2048 alignment, whose candidate batches the
  likelihood kernel (K3/K4) ranks, then the Newton branch-length fit;
- the default ML route (``--criterion ml``, analytic SPR scan, plain
  torch) on 128 x 1024 with ``--rounds 5``, a reduced size;
- the weighted-parsimony NNI climb (stepwise start, then
  ``parsimony_hill_climb`` under transition/transversion costs on integer
  states) on 512 x 2048, whose candidate batches the min-plus Sankoff
  kernel (K5) scores;
- ``score`` on a generated 512-leaf mutation tree (its score held against
  K5's rescoring), and ``bench`` on 64 x 1024 with 61 states (K5) and 4
  (K1);
- the level-synchronous Fitch scorer (K6) on the balanced level-order tree
  at ``tools/fitch_levels_ab.py``'s shapes (a)-(f), each held bit for bit
  against its plain version and against K1 on the same topology, with its
  mode (bit-sliced planes or one site per word) and its split, and the
  split over calls of changing batch.

It also profiles the default ``infer``'s two calls (stepwise addition,
SPR-scan climb), the NNI route, the ML NNI route's two (climb, Newton fit)
and the weighted climb with ``torch.profiler`` for the device's busy and idle share
and the top kernels, and checks on small divergent alignments that the
card returns the same results as the CPU: ``infer`` for both criteria and
both neighborhoods, the weighted climb, ``score --alignment``, and
stepwise addition on masks with bits above the alphabet.

Each phase prints one JSON line. The line before the last is
``{"kernels": [...]}``; the last is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Any failure raises and exits non-zero; so does a machine without a CUDA
device, or a directory without the port beside this script.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import itertools
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

SEED = 0
# Published H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, and the
# float32 FMA rate outside the tensor cores (128 lanes x 2 flops per SM per
# clock), for the float work of K3/K4 and K5.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# float32 instructions outside the tensor cores: 128 per SM per clock x 132
# SMs x the 1980 MHz SM clock; for K5, whose adds and mins no instruction
# fuses. The bound the kernels' global-scratch versions were held to (two
# messages an ancestor, K5's at F32_OPS_PER_S) is kept beside each K5 and
# K3/K4 bound as bound_ms_earlier.
F32_INSTR_PER_S = 128 * 132 * 1.98e9
# 32-bit integer add and logical results: 64 per SM per clock on compute
# capability 9.0 (CUDA C++ Programming Guide, arithmetic instruction
# throughput table) x 132 SMs x the 1980 MHz SM clock; for K1 and K2.
INT32_OPS_PER_S = 64 * 132 * 1.98e9
# K1 at (a) bench.py's headline, 5% ambiguous DNA masks; (d) 20 and (e) 32
# states; (f) a big table; (g) the long alignment for which the TPU took
# its 4-sites-a-word layout; (h) (a) at 6 states, the kernel's 8-plane
# mode; (i) trees too large for shared memory, the global mode. (b), the
# main path's rescoring, and (c), the NNI route's batch, are taken from
# those routes' own runs.
K1_SHAPES = {
    "a": dict(n_taxa=64, n_sites=1024, batch=2048, n_states=4),
    "d": dict(n_taxa=64, n_sites=1024, batch=512, n_states=20),
    "e": dict(n_taxa=64, n_sites=1024, batch=64, n_states=32),
    "f": dict(n_taxa=2048, n_sites=1024, batch=4, n_states=4),
    "g": dict(n_taxa=64, n_sites=8192, batch=256, n_states=4),
    "h": dict(n_taxa=64, n_sites=1024, batch=2048, n_states=6),
    "i": dict(n_taxa=8192, n_sites=1024, batch=4, n_states=4),
}
K1_SHAPE = K1_SHAPES["a"]
K34_SHAPE = dict(n_taxa=64, n_sites=1024, batch=1024)
K4_BRANCH_SHAPE = dict(n_taxa=64, n_sites=1024, batch=256)
MAIN_SHAPE = dict(n_taxa=512, n_sites=2048)
NNI_SHAPE = dict(n_taxa=128, n_sites=1024)
ML_SCAN_SHAPE = dict(n_taxa=128, n_sites=1024)
REF_SHAPE = dict(n_taxa=24, n_sites=300)
K5_BENCH_SHAPE = dict(n_taxa=64, n_sites=1024, batch=2048)
K5_Q20_SHAPE = dict(n_taxa=64, n_sites=1024, batch=256, n_states=20)
K5_Q61_SHAPE = dict(n_taxa=64, n_sites=1024, batch=64, n_states=61)
# K5 and K3/K4 on deep trees: caterpillars (one slot, 2047 steps) and
# random trees (7-8 slots, where index order keeps about 500 rows live).
DEEP_SHAPE = dict(n_taxa=2048, n_sites=1024, batch=4)
# K5's global-slot mode: Q = 128 on 2048 taxa needs 11 slots of 128 rows a
# site beside a 64 KB cost matrix, more than a block's shared memory.
K5_GLOBAL_SHAPE = dict(n_taxa=2048, n_sites=256, batch=4, n_states=128)
# The tree plan kernel: beside the DP kernels' shapes, trees too large to
# stage in shared memory (above about 17,800 taxa on an H100).
PLAN_WIDE = dict(n_taxa=20_000, batch=2)
# K2 at real stepwise insertions: (a) the main path's alignment halfway,
# (b) the same early (long parked chain) and last, (c) 2048 taxa, whose
# 16 KB-per-site table shrinks the sites per block, (d) 20-state masks.
K2_SHAPES = (
    dict(shape="a", n_taxa=512, n_sites=2048, n_states=4, insertion=256),
    dict(shape="b", n_taxa=512, n_sites=2048, n_states=4, insertion=8),
    dict(shape="b", n_taxa=512, n_sites=2048, n_states=4, insertion=511),
    dict(shape="c", n_taxa=2048, n_sites=1024, n_states=4, insertion=1024),
    dict(shape="d", n_taxa=256, n_sites=1024, n_states=20, insertion=128),
)
# (e) a random pruned tree too large for the up rows to sit beside the
# down table, so the kernel reads them from global memory.
K2_WIDE = dict(shape="e", n_taxa=10_000, n_sites=64)
# K6 (and K1 beside it) on the balanced level-order tree: (a) the JAX
# A/B's own shape (benchmarks/fitch_levels.py), (b) the main path's
# rescoring size (K1's 511-step chain at B = 1), (c) the NNI route's size,
# (d) 20 states with bit 31 in 5% of the masks (the one-site-per-word
# mode), (e) 2048 leaves at B = 1 (the bit-sliced split; at 32 states
# the one-site-per-word mode reads its rows from global memory), (f) (a)
# at 6 states (8 planes); (a1024) (a) at half the batch
# (``tools/fitch_levels_ab.py`` only).
K6_SHAPES = {
    "a": dict(n_leaves=64, n_sites=1024, batch=2048, n_states=4),
    "a1024": dict(n_leaves=64, n_sites=1024, batch=1024, n_states=4),
    "b": dict(n_leaves=512, n_sites=2048, batch=1, n_states=4),
    "c": dict(n_leaves=128, n_sites=1024, batch=256, n_states=4),
    "d": dict(n_leaves=64, n_sites=1024, batch=512, n_states=20, bit31=True),
    "e": dict(n_leaves=2048, n_sites=2048, batch=1, n_states=4),
    "f": dict(n_leaves=64, n_sites=1024, batch=2048, n_states=6),
}
# The mode and parts of K6's plan at each shape on an H100: (b) at B = 1
# one site per word (faster there than the bit-sliced split), (e) split
# over 32 blocks a chunk.
K6_PLANS = {
    "a": ("4 planes", 1), "a1024": ("4 planes", 1), "b": ("one site per word", 1),
    "c": ("4 planes", 1), "d": ("one site per word", 1), "e": ("4 planes", 32),
    "f": ("8 planes", 1),
}
WEIGHTED_ROUNDS = 10
SCORE_ARGS = ["score", "--leaves", "512", "--sites", "2048", "--states", "4"]
BENCH_ARGS = ["bench", "--leaves", "64", "--sites", "1024", "--batch", "512", "--reps", "5"]
K34_RTOL = 1e-5
RANKING_LENGTH = 0.1


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def simulate_fasta(
    path: str, n_taxa: int, n_sites: int, seed: int, branch=(0.02, 0.1),
    missing: float = 0.01,
) -> None:
    """JC69 alignment down a random coalescent tree, branch lengths
    uniform in ``branch``, with a ``missing`` share of characters replaced
    by N or -."""
    rng = np.random.default_rng(seed)
    kids: dict[int, tuple[int, int]] = {}
    active = list(range(n_taxa))
    node = n_taxa
    while len(active) > 1:
        i, j = rng.choice(len(active), size=2, replace=False)
        a, b = active[i], active[j]
        kids[node] = (a, b)
        active = [x for x in active if x not in (a, b)] + [node]
        node += 1
    root = active[0]
    seqs = {root: rng.integers(0, 4, n_sites)}
    stack = [root]
    while stack:
        parent = stack.pop()
        for child in kids.get(parent, ()):
            p_change = 0.75 * (1.0 - np.exp(-4.0 / 3.0 * rng.uniform(*branch)))
            seq = seqs[parent].copy()
            hit = rng.random(n_sites) < p_change
            seq[hit] = rng.integers(0, 4, int(hit.sum()))
            seqs[child] = seq
            stack.append(child)
    letters = np.frombuffer(b"ACGT", dtype=np.uint8)
    with open(path, "w") as fh:
        for t in range(n_taxa):
            row = letters[seqs[t]].copy()
            hit = rng.random(n_sites) < missing
            row[hit] = rng.choice(np.frombuffer(b"N-", dtype=np.uint8), int(hit.sum()))
            fh.write(f">taxon{t}\n{row.tobytes().decode()}\n")


def random_trees(rng, n_taxa: int, batch: int) -> np.ndarray:
    """(batch, n_taxa - 1, 2) int32 children of random coalescent trees
    (child index < parent index, root last)."""
    children = np.empty((batch, n_taxa - 1, 2), np.int32)
    for b in range(batch):
        active = list(range(n_taxa))
        for a in range(n_taxa - 1):
            x = active.pop(int(rng.integers(len(active))))
            j = int(rng.integers(len(active)))
            y = active[j]
            active[j] = n_taxa + a
            children[b, a] = (min(x, y), max(x, y))
    return children


def caterpillar_trees(rng, n_taxa: int, batch: int) -> np.ndarray:
    """(batch, n_taxa - 1, 2) int32 children of caterpillars (each ancestor
    joins the previous one and one more leaf), leaves in random orders."""
    children = np.empty((batch, n_taxa - 1, 2), np.int32)
    for b in range(batch):
        leaf = rng.permutation(n_taxa).astype(np.int32)
        children[b, 0] = (leaf[0], leaf[1])
        children[b, 1:, 0] = np.arange(n_taxa, 2 * n_taxa - 2)
        children[b, 1:, 1] = leaf[2:]
    return children


def deep_inputs(torch, device) -> dict:
    """{shape: (children, states, weights)} at DEEP_SHAPE: 4 caterpillars
    and 4 random trees on random states 0..3 with weights 1..5, drawn in
    that order from seed SEED + 30."""
    rng = np.random.default_rng(SEED + 30)
    n, length, batch = DEEP_SHAPE.values()
    out = {}
    for key, make in (("deep caterpillar", caterpillar_trees), ("deep random", random_trees)):
        children = make(rng, n, batch)
        states = rng.integers(0, 4, (n, length)).astype(np.int32)
        weights = rng.integers(1, 6, length).astype(np.float32)
        out[key] = tuple(torch.as_tensor(x, device=device) for x in (children, states, weights))
    return out


def asymmetric_cost(rng, q: int) -> np.ndarray:
    """(q, q) f32 integer costs 0..3 drawn from ``rng``, 0 on the diagonal."""
    cost = rng.integers(0, 4, (q, q)).astype(np.float32)
    np.fill_diagonal(cost, 0.0)
    return cost


def transition_transversion_cost(torch, device):
    from trex_tpu_torch.types import CostModel

    return CostModel.transition_transversion(1.0, 2.0, device=device).matrix


def route_batches(torch, device, workdir: str) -> dict:
    """Inputs like K5 (b) and K3/K4 (b) (= K5 (c)): the NNI neighbourhood of
    a random 512-taxon tree on the weighted route's alignment (states,
    weights 1) and on the main path's (compressed masks, pattern counts)."""
    from trex_tpu_torch.alignment import compress_alignment
    from trex_tpu_torch.cli._common import _load_alignment
    from trex_tpu_torch.io import nni_neighbors_host
    from trex_tpu_torch.topology import from_numpy, parents_from_children

    tree = random_trees(np.random.default_rng(SEED), MAIN_SHAPE["n_taxa"], 1)[0]
    batch = torch.as_tensor(
        nni_neighbors_host(from_numpy(tree, parents_from_children(tree)))[0], device=device)
    wt_fasta = os.path.join(workdir, "weighted.fasta")
    simulate_fasta(wt_fasta, MAIN_SHAPE["n_taxa"], MAIN_SHAPE["n_sites"], SEED + 5,
                   branch=(0.05, 0.3), missing=0.0)
    wt = torch.as_tensor(dna_states(wt_fasta), device=device)
    main_fasta = os.path.join(workdir, "main.fasta")
    simulate_fasta(main_fasta, MAIN_SHAPE["n_taxa"], MAIN_SHAPE["n_sites"], SEED + 1)
    patterns, counts = compress_alignment(_load_alignment(main_fasta, "dna")[1])
    return {
        "weighted": (batch, wt, torch.ones((wt.shape[1],), device=device)),
        "ml": (batch, torch.as_tensor(patterns.astype(np.int32), device=device),
               torch.as_tensor(counts.astype(np.float32), device=device)),
    }


def k1_masks(rng, n_taxa: int, n_sites: int, n_states: int) -> np.ndarray:
    """(n_taxa, n_sites) int32 state-set masks: single states, 5% of them
    random non-empty subsets; at 32 states bit 31 (the int32 sign bit) is
    set too."""
    masks = np.left_shift(np.int64(1), rng.integers(0, n_states, (n_taxa, n_sites)))
    ambiguous = rng.random((n_taxa, n_sites)) < 0.05
    masks[ambiguous] = rng.integers(1, 1 << n_states, int(ambiguous.sum()), dtype=np.int64)
    return (masks - ((masks >> 31) << 32)).astype(np.int32)


def k1_inputs(torch, device, key: str, rng):
    """(children, masks, weights, n_states) of K1 shape ``key`` of
    K1_SHAPES: masks, random trees, then weights 1..5, drawn from ``rng``
    in that order."""
    shape = K1_SHAPES[key]
    n, length, q = shape["n_taxa"], shape["n_sites"], shape["n_states"]
    masks = k1_masks(rng, n, length, q)
    children = random_trees(rng, n, shape["batch"])
    weights = rng.integers(1, 6, length).astype(np.float32)
    return (torch.as_tensor(children, device=device), torch.as_tensor(masks, device=device),
            torch.as_tensor(weights, device=device), q)


def k1_route_inputs(torch, device, workdir: str, key: str):
    """(children, masks, weights, n_states) like K1's route shapes: (b) one
    random 512-taxon tree on the main path's compressed alignment, (c) the
    NNI neighbourhood of a random 128-taxon tree on the NNI route's."""
    from trex_tpu_torch.alignment import compress_alignment
    from trex_tpu_torch.cli._common import _load_alignment
    from trex_tpu_torch.io import nni_neighbors_host
    from trex_tpu_torch.topology import from_numpy, parents_from_children

    shape, seed = (MAIN_SHAPE, SEED + 1) if key == "b" else (NNI_SHAPE, SEED + 2)
    fasta = os.path.join(workdir, f"k1_{key}.fasta")
    simulate_fasta(fasta, shape["n_taxa"], shape["n_sites"], seed)
    patterns, counts = compress_alignment(_load_alignment(fasta, "dna")[1])
    tree = random_trees(np.random.default_rng(SEED), shape["n_taxa"], 1)
    if key == "c":
        tree = nni_neighbors_host(from_numpy(tree[0], parents_from_children(tree[0])))[0]
    return (torch.as_tensor(tree, device=device),
            torch.as_tensor(np.ascontiguousarray(patterns, dtype=np.int32), device=device),
            torch.as_tensor(counts.astype(np.float32), device=device), 4)


def time_ms(torch, fn, reps: int, warmup: int = 2) -> float:
    """Median milliseconds of one call of ``fn`` over ``reps`` calls after
    ``warmup`` calls: CUDA events around each call, which waits for the
    device before the next, so each time includes the call's host work."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def back_to_back_ms(torch, fn, reps: int) -> float:
    """Milliseconds per call of ``fn`` over ``reps`` calls enqueued back to
    back between two CUDA events: the host's work on the next call overlaps
    the device's on this one, so this is nearer the device time alone."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(n_bytes: float, n_ops: float, ops_per_s: float = F32_OPS_PER_S) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def measure(
    torch, kernel, plain, n_bytes: float, n_ops: float, reps: int = 30,
    rtol: float | None = None, plain_reps: int = 5, ops_per_s: float = F32_OPS_PER_S,
) -> dict:
    """Hold ``kernel()`` against ``plain()`` — bit for bit, or within
    ``rtol`` of |plain| — and time both (``ms``: the per-call median);
    the bound takes ``n_ops`` at ``ops_per_s``."""
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    err = float((got - want).abs().max()) if got.numel() else 0.0
    rel = None
    if rtol is not None:
        rel = float(((got - want).abs() / want.abs()).max()) if got.numel() else 0.0
    if rtol is None and not torch.equal(got, want):
        raise AssertionError(f"kernel differs from its plain version (max abs err {err})")
    if rtol is not None and not (bool(torch.isfinite(got).all()) and rel <= rtol):
        raise AssertionError(
            f"kernel differs from its plain version: max rel err {rel} > {rtol}"
        )
    again = kernel()
    torch.cuda.synchronize()
    if not torch.equal(again, got):
        raise AssertionError("kernel does not reproduce its own result bit for bit")
    bound, bound_by = bound_ms(n_bytes, n_ops, ops_per_s)
    return {
        "equal": bool(torch.equal(got, want)), "max_abs_err": err, "max_rel_err": rel,
        "ms": time_ms(torch, kernel, reps),
        "ms_back_to_back": back_to_back_ms(torch, kernel, reps),
        "plain_ms": time_ms(torch, plain, plain_reps, 1),
        "bound_ms": bound, "bound_by": bound_by,
    }


def k1_work(batch: int, n_taxa: int, n_sites: int, n_states: int) -> tuple[float, float]:
    """K1's (bytes, int32 ops): children, leaves, weights in, scores out;
    the bit-sliced update per (tree, ancestor, 32-site word) — the least
    work known for the function: Q ANDs and 3-input ORs for o = OR_q
    (a_q & b_q) (the first plane an AND, each next one LOP3), Q LOP3s for
    new_q = (a_q & b_q) | (~o & (a_q | b_q)), and 4 for the event counter
    (a 3-plane vertical counter's increment): 2Q + 4."""
    n_bytes = 4.0 * (batch * (n_taxa - 1) * 2 + n_taxa * n_sites + n_sites + batch)
    words = -(-n_sites // 32)
    return n_bytes, float(batch * (n_taxa - 1) * words * (2 * n_states + 4))


def k34_work(batch: int, n_taxa: int, n_sites: int, q: int, per_branch: bool, *,
             leaf_table: bool):
    """K3/K4's (bytes, float32 ops): children, leaves, weights, prior and P
    in, scores out; per tree and site 2Q^2 (Q^2 FMAs) for each message
    computed, Q for the combine, 2Q for the max and the scale per ancestor.
    With ``leaf_table`` (shared P) a leaf's message depends only on its
    state, so only the n_taxa - 2 ancestor children's messages are computed
    (the table: a few rows a block); without it, two an ancestor, as the
    global-scratch version did throughout."""
    p_floats = batch * (2 * n_taxa - 1) * q * q if per_branch else q * q
    n_bytes = 4.0 * (
        batch * (n_taxa - 1) * 2 + n_taxa * n_sites + n_sites + q + p_floats + batch
    )
    messages = n_taxa - 2 if leaf_table else 2 * (n_taxa - 1)
    return n_bytes, float(batch * n_sites * (messages * 2 * q * q + (n_taxa - 1) * 3 * q))


def k5_work(batch: int, n_taxa: int, n_sites: int, q: int, hamming: bool, *,
            leaf_table: bool):
    """K5's (bytes, float32 ops): children, leaves, cost and weights in,
    scores out; per tree and site, Q^2 x (add + min) for each general
    message computed (Hamming: Q - 1 mins, 1 add, Q mins), Q adds per
    ancestor to combine two messages, a Q - 1 min and the weight multiply.
    With ``leaf_table`` a leaf's message depends only on its state, so only
    the n_taxa - 2 ancestor children's messages are computed (the table: a
    few rows a block); without it, two an ancestor, as the global-scratch
    version did throughout."""
    n_bytes = 4.0 * (batch * (n_taxa - 1) * 2 + n_taxa * n_sites + q * q + n_sites + batch)
    per_message = 2 * q if hamming else 2 * q * q
    messages = n_taxa - 2 if leaf_table else 2 * (n_taxa - 1)
    return n_bytes, float(batch * n_sites * (messages * per_message + (n_taxa - 1) * q + q))


def plan_work(batch: int, n_taxa: int) -> tuple[float, float]:
    """The tree plan's (bytes, int32 ops): children in, 16-byte steps out;
    per tree and ancestor about 40 integer operations over the two passes
    (child tests, need and count updates, offsets, depths, the step)."""
    return 24.0 * batch * (n_taxa - 1), 40.0 * batch * (n_taxa - 1)


def k6_inputs(torch, device, key: str):
    """(masks, children, weights, alphabet, states used) of K6 shape
    ``key``: masks as ``k1_masks`` from seed SEED + 10 (bit 31 added to 5%
    of them where the shape says so), the balanced level-order children
    repeated for K1, weights 1, the alphabet K1 is handed (one past the
    highest bit the masks use) and the number of bits they use."""
    from trex_tpu_torch.ops.fitch_levels import balanced_topology_levels

    shape = K6_SHAPES[key]
    n, length, batch = shape["n_leaves"], shape["n_sites"], shape["batch"]
    rng = np.random.default_rng(SEED + 10)
    masks = k1_masks(rng, n, length, shape["n_states"]).astype(np.int64)
    if shape.get("bit31"):
        masks[rng.random(masks.shape) < 0.05] |= 1 << 31
    masks = (masks - ((masks >> 31) << 32)).astype(np.int32)
    children = balanced_topology_levels(n, device).children
    used = int(np.bitwise_or.reduce(masks.astype(np.uint32), axis=None))
    return (torch.as_tensor(masks, device=device),
            children[None].expand(batch, -1, -1).contiguous(),
            torch.ones((length,), device=device), used.bit_length(), bin(used).count("1"))


def k6_work(batch: int, n_leaves: int, n_sites: int, states_used: int) -> tuple[float, float]:
    """K6's (bytes, int32 ops): the leaf masks in, the scores out; K1's
    count of 2Q + 4 per (tree, ancestor, 32-site word), the same work, Q
    the states the masks use (``states_used``, bits set anywhere)."""
    n_bytes = 4.0 * (n_leaves * n_sites + batch)
    words = -(-n_sites // 32)
    return n_bytes, float(batch * (n_leaves - 1) * words * (2 * states_used + 4))


def device_ms(torch, fn, reps: int = 10) -> float:
    """Device milliseconds per call of ``fn`` (every kernel and memset it
    launches) under ``torch.profiler`` (for the tools; after this script's
    profile phases it read 0 for some kernels, so its K6 phase takes
    ``graph_ms``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return sum(e.self_device_time_total for e in events) / 1e3 / reps


def graph_ms(torch, fn, calls: int = 20, replays: int = 5) -> float:
    """Device milliseconds per call of ``fn``: ``calls`` calls captured in
    one CUDA graph, replayed ``replays`` times between two CUDA events, so
    no host work runs between the kernels (a launch gap of about 1 us a
    kernel stays in)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (calls * replays)


def k2_alignment(fasta_dir: str, n_taxa: int, n_sites: int, n_states: int, seed: int):
    """(patterns, pattern counts) of a K2 shape's alignment: a simulated
    DNA FASTA through the CLI's loader and compression for 4 states,
    random 20-state masks (5% ambiguous subsets) with weights 1..3 else."""
    from trex_tpu_torch.alignment import compress_alignment
    from trex_tpu_torch.cli._common import _load_alignment

    if n_states == 4:
        fasta = os.path.join(fasta_dir, f"k2_{n_taxa}x{n_sites}.fasta")
        simulate_fasta(fasta, n_taxa, n_sites, seed)
        patterns, counts = compress_alignment(_load_alignment(fasta, "dna")[1])
        return patterns.astype(np.int32), counts.astype(np.float32)
    rng = np.random.default_rng(seed)
    masks = (1 << rng.integers(0, n_states, (n_taxa, n_sites))).astype(np.int32)
    ambiguous = rng.random((n_taxa, n_sites)) < 0.05
    masks[ambiguous] = rng.integers(1, 1 << n_states, int(ambiguous.sum()))
    return masks, rng.integers(1, 4, n_sites).astype(np.float32)


def k2_insertions(patterns, counts, n_states: int, steps, device):
    """Yield (step, (var, up, t, weights)) — K2's inputs at each stepwise
    insertion in ``steps`` (ascending), the tree grown by the port's own
    loop in a seeded random order."""
    from trex_tpu_torch.search import stepwise

    order = [int(t) for t in np.random.default_rng(SEED).permutation(patterns.shape[0])]
    st = stepwise._seed_state(patterns, order, (1 << n_states) - 1, counts, device)
    k = 3
    for step in steps:
        for k in range(k, step):
            stepwise._insert(st, k)
        k = step
        var, up, t = stepwise._insertion_inputs(st, step)
        yield step, (var, up, t, st.weights)


def k2_wide_inputs(torch, device, n_taxa: int, n_sites: int, seed: int):
    """K2's inputs (var, up, t, weights) on a random tree with one leaf
    pruned (its parent row a pass-through pair), random masks 1..15 in
    every up row and the event flag (bit 30) on a third of the internal
    rows, weights 1..3."""
    rng = np.random.default_rng(seed)
    children = random_trees(rng, n_taxa, 1)[0]
    t = int(rng.integers(n_taxa))
    row = int(np.nonzero((children == t).any(axis=1))[0][0])
    sibling = int(children[row].sum() - t)
    children[row] = (sibling, sibling)
    up = rng.integers(1, 16, (2 * n_taxa - 1, n_sites)).astype(np.int32)
    up[n_taxa:][rng.random(n_taxa - 1) < 1 / 3] |= 1 << 30
    weights = rng.integers(1, 4, n_sites).astype(np.float32)
    return (torch.as_tensor(children, device=device), torch.as_tensor(up, device=device),
            t, torch.as_tensor(weights, device=device))


def k2_work(n_all: int, sites: int) -> tuple[float, float]:
    """K2's (bytes, int32 ops): children, up table and weights in, delta
    out; the down pass's two combine0 (7 ops each) per ancestor and site,
    the delta pass's combine0, AND, compare, select and add per node and
    site."""
    n_bytes = 4.0 * ((n_all // 2) * 2 + n_all * sites + sites + n_all)
    return n_bytes, 14.0 * (n_all // 2) * sites + 11.0 * n_all * sites


def strip_lengths(newick: str) -> str:
    import re

    return re.sub(r":[0-9.eE+-]+", "", newick)


def run_cli(argv: list[str]):
    """The ``infer``, ``score`` or ``bench`` command in this process; returns
    what its ``run_*`` function returns (InferRun, the JSON object, or the
    JSON object and the scores)."""
    from trex_tpu_torch.cli import build_parser
    from trex_tpu_torch.cli.infer import run_infer
    from trex_tpu_torch.cli.score import run_score
    from trex_tpu_torch.cli.search_cmds import run_bench

    run = {"infer": run_infer, "score": run_score, "bench": run_bench}[argv[0]]
    with contextlib.redirect_stdout(io.StringIO()):
        return run(build_parser().parse_args(argv))


def dna_states(fasta: str) -> np.ndarray:
    """(n, L) int32 ACGT states of a FASTA file without ambiguity codes."""
    from trex_tpu_torch.cli._common import _load_alignment

    _, masks, _ = _load_alignment(fasta, "dna")
    single = masks[..., None] == (1 << np.arange(4, dtype=np.int32))
    if not single.any(-1).all():
        raise ValueError(f"{fasta} has ambiguous characters")
    return single.argmax(-1).astype(np.int32)


def profile_phase(torch, fn, unprofiled_wall: float | None) -> dict:
    """Device-busy time and the top kernels of ``fn()`` under
    ``torch.profiler``. One stream, so the summed kernel and copy time is
    the busy time; the idle share is taken against the same call's wall
    time without the profiler (``unprofiled_wall``), since tracing
    ~10^5 launches slows the host — or, for ``None``, against the
    profiled call's own wall time (a call of few launches)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if unprofiled_wall is None:
        unprofiled_wall = wall
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in events) / 1e6
    top = sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:8]
    return {
        "profiled_wall_s": wall, "unprofiled_wall_s": unprofiled_wall,
        "device_busy_s": busy, "idle_share": 1.0 - busy / unprofiled_wall,
        "device_launches": int(sum(e.count for e in events)),
        "top": [{"name": e.key[:80], "count": e.count,
                 "device_s": e.self_device_time_total / 1e6} for e in top],
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to measure", file=sys.stderr)
        return 1
    from trex_tpu_torch.alignment import compress_alignment
    from trex_tpu_torch.cli._common import _load_alignment
    from trex_tpu_torch.io import nni_neighbors_host
    from trex_tpu_torch._device import device_limits
    from trex_tpu_torch.ops import _nvcc
    from trex_tpu_torch.ops.fitch_cuda import (
        batched_fitch_score_cuda,
        batched_fitch_score_plain,
    )
    from trex_tpu_torch.ops.fitch_cuda import launch_plan as k1_plan
    from trex_tpu_torch.ops.fitch_levels import (
        fitch_levels_balanced,
        fitch_levels_plain,
    )
    from trex_tpu_torch.ops.fitch_levels import launch_plan as k6_plan
    from trex_tpu_torch.ops.fitch_levels import run_plan as run_k6_plan
    from trex_tpu_torch.ops.fitch_levels import sliced_plan as k6_sliced_plan
    from trex_tpu_torch.ops.insertion_cuda import (
        insertion_delta_cuda,
        insertion_delta_plain,
        launch_plan,
    )
    from trex_tpu_torch.ops.likelihood import jc69_transition
    from trex_tpu_torch.ops.likelihood_asr import optimize_branch_lengths_newton
    from trex_tpu_torch.ops.likelihood_cuda import (
        batched_log_likelihood_cuda,
        batched_log_likelihood_plain,
    )
    from trex_tpu_torch.ops.likelihood_cuda import launch_plan as k34_plan
    from trex_tpu_torch.ops.dispatch import batched_scores_fastest
    from trex_tpu_torch.ops.sankoff_cuda import (
        batched_sankoff_score_cuda,
        batched_sankoff_score_plain,
    )
    from trex_tpu_torch.ops.sankoff_cuda import launch_plan as k5_plan
    from trex_tpu_torch.ops.tree_plan import plan_launch, slots_for, tree_plan, tree_plan_plain
    from trex_tpu_torch.search import stepwise
    from trex_tpu_torch.search.hillclimb import parsimony_hill_climb
    from trex_tpu_torch.search.ml import ml_hill_climb
    from trex_tpu_torch.cli import build_parser
    from trex_tpu_torch.cli.search_cmds import bench_inputs
    from trex_tpu_torch.models.mutation_tree import generate_groundtruth
    from trex_tpu_torch.topology import Topology, balanced_topology
    from trex_tpu_torch.types import CostModel

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    wrappers = {
        "k1": batched_fitch_score_cuda, "k2": insertion_delta_cuda,
        "k34": batched_log_likelihood_cuda, "k5": batched_sankoff_score_cuda,
        "k6": fitch_levels_balanced, "plan": tree_plan,
    }

    def reset_counts() -> None:
        for fn in wrappers.values():
            fn.launches = 0
            if hasattr(fn, "calls"):
                fn.calls = 0

    def launch_counts() -> dict:
        return {name: fn.launches for name, fn in wrappers.items()}

    def call_counts() -> dict:
        """Calls that launched, of the wrappers that count them (K5, K3/K4)."""
        return {name: fn.calls for name, fn in wrappers.items() if hasattr(fn, "calls")}

    def device_times(fn, ms: float) -> dict:
        """Device ms a call of ``fn``: a CUDA graph of calls (fewer where a
        call is slow), with about 1 us of launch gap a kernel. Not the
        profiler's: after the profile phases it reads low, or 0, in this
        process (1.8 of K5 (b)'s 3.6 ms, 0 of the global-slot shape's 82)."""
        calls = max(2, min(20, int(200 / max(ms, 1e-3))))
        return {"device_ms": graph_ms(torch, fn, calls, 2 if calls < 20 else 5)}

    # 1. Card.
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    emit("card", nvidia_smi=smi, device_name=kind,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)

    # 2. Build the six kernel libraries from the checkout's sources, in
    # parallel.
    t0 = time.perf_counter()
    _nvcc.build()
    ptxas = {
        name: [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
        for name, log in _nvcc.BUILD_LOG.items()
    }
    emit("build", seconds=time.perf_counter() - t0, ptxas=ptxas)

    workdir = tempfile.mkdtemp(prefix="trex_chip_smoke_")

    def k1_on(children, masks, weights, n_states=4, plain_reps=5) -> dict:
        plan = k1_plan(children.shape[0], masks.shape[0], masks.shape[1], n_states,
                       *device_limits(dev))
        return dict(plan=dataclasses.asdict(plan), **measure(
            torch,
            lambda: batched_fitch_score_cuda(children, masks, weights, n_states=n_states),
            lambda: batched_fitch_score_plain(children, masks, weights),
            *k1_work(children.shape[0], masks.shape[0], masks.shape[1], n_states),
            ops_per_s=INT32_OPS_PER_S, plain_reps=plain_reps,
        ))

    # 3. K1 at bench.py's shape (a): 64 taxa x 1024 sites, B = 2048 trees;
    # then at (d)-(i), each with its launch plan ((i) in the global mode,
    # whose plain version walks 8191 ancestors: 2 timed calls).
    rng = np.random.default_rng(SEED)
    k1 = k1_on(*k1_inputs(torch, dev, "a", rng))
    emit("k1", shape="a", **K1_SHAPE, trees_per_s=K1_SHAPE["batch"] / (k1["ms"] / 1e3), **k1)
    k1_shapes = {"a": dict(K1_SHAPE, **k1)}
    for key in "defghi":
        k1_shapes[key] = dict(K1_SHAPES[key], **k1_on(
            *k1_inputs(torch, dev, key, np.random.default_rng(SEED + ord(key))),
            plain_reps=2 if key == "i" else 5))
        emit("k1", shape=key, **k1_shapes[key])
    if k1_shapes["i"]["plan"]["staged"]:
        raise AssertionError(f"K1 (i) did not take the global mode: {k1_shapes['i']['plan']}")

    # 4. K2 at real stepwise insertions, shapes (a)-(d) of K2_SHAPES, and on
    # the wide tree (e), each bit for bit against its plain version, with
    # its launch plan.
    main_fasta = os.path.join(workdir, "main.fasta")
    simulate_fasta(main_fasta, MAIN_SHAPE["n_taxa"], MAIN_SHAPE["n_sites"], SEED + 1)
    _, aln, n_states = _load_alignment(main_fasta, "dna")
    patterns, counts = compress_alignment(aln)

    def k2_on(var, up, t, w, plain_reps=5) -> dict:
        n_all, sites = up.shape
        limits = device_limits(dev)
        plan = launch_plan(n_all, sites, limits.smem_optin, limits.n_sms)
        return dict(padded_patterns=sites, plan=dataclasses.asdict(plan), **measure(
            torch, lambda: insertion_delta_cuda(var, up, t, w),
            lambda: insertion_delta_plain(var, up, t, w), *k2_work(n_all, sites),
            plain_reps=plain_reps, ops_per_s=INT32_OPS_PER_S))

    k2_shapes = []
    for key, group in itertools.groupby(K2_SHAPES, lambda c: (c["n_taxa"], c["n_sites"])):
        group = list(group)
        q = group[0]["n_states"]
        pats, cnts = k2_alignment(workdir, *key, q, SEED + 1)
        for step, inputs in k2_insertions(
                pats, cnts, q, sorted(c["insertion"] for c in group), dev):
            cell = next(c for c in group if c["insertion"] == step)
            k2_shapes.append(dict(cell, **k2_on(*inputs)))
            emit("k2", **k2_shapes[-1])
    k2_shapes.append(dict(K2_WIDE, **k2_on(
        *k2_wide_inputs(torch, dev, K2_WIDE["n_taxa"], K2_WIDE["n_sites"], SEED), plain_reps=2)))
    emit("k2", **k2_shapes[-1])
    k2 = next(c for c in k2_shapes if c["shape"] == "a")

    # 5. Main path: the default infer on 512 x 2048, on the card. The
    # parsimony path ranks nothing by likelihood: K3/K4 must not launch.
    reset_counts()
    t0 = time.perf_counter()
    run = run_cli(["infer", "--alignment", main_fasta])
    torch.cuda.synchronize()
    main_wall = time.perf_counter() - t0
    main_counts = launch_counts()
    main_k1, main_k2, main_k34 = (main_counts[k] for k in ("k1", "k2", "k34"))
    if (main_k2 <= 0 or main_k1 <= 0 or main_k34 != 0 or main_counts["k5"] != 0
            or main_counts["plan"] != 0):
        raise AssertionError(f"main path launches: {main_counts}")
    out = run.out
    # K1 at the main path's own shape (one tree, 512 x 2048): the returned
    # tree rescored by the kernel and the plain version must both give the
    # reported score.
    tree = run.result.topology.children[None].contiguous()
    pat_t = torch.as_tensor(patterns.astype(np.int32), device=dev)
    w_t = torch.as_tensor(counts.astype(np.float32), device=dev)
    k1_main = k1_on(tree, pat_t, w_t)
    rescored = float(batched_fitch_score_cuda(tree, pat_t, w_t)[0])
    if rescored != out["parsimony_score"]:
        raise AssertionError(f"rescored tree {rescored} != reported {out['parsimony_score']}")
    emit("main_path", command="infer (defaults)", n_taxa=out["n_taxa"],
         n_sites=out["n_sites"], unique_patterns=out["unique_patterns"],
         parsimony_score=out["parsimony_score"], search_rounds=out["search_rounds"],
         evaluations=out["evaluations"], stepwise_s=run.seconds["start"],
         climb_s=run.seconds["climb"], wall_s=main_wall,
         k1_launches=main_k1, k2_launches=main_k2, k34_launches=main_k34,
         k5_launches=main_counts["k5"], rescored=rescored,
         k1_at_this_shape=k1_main)

    # 5b. Where the main path's time goes: its two calls, profiled one by one.
    starts = []
    emit("profile", part="stepwise (4 orders)", **profile_phase(
        torch,
        lambda: starts.append(stepwise.stepwise_addition_multi(
            patterns, n_states, n_orders=4, seed=0, sequences_are_masks=True,
            site_weights=w_t, device=dev)[0]),
        run.seconds["start"]))
    emit("profile", part="spr-scan climb", **profile_phase(
        torch,
        lambda: parsimony_hill_climb(
            starts[0], CostModel.hamming(n_states, device=dev).matrix, pat_t,
            neighborhood="spr-scan", site_weights=w_t, sequences_are_masks=True),
        run.seconds["climb"]))

    # 5c. K3/K4 against its plain version at three shapes.
    p_shared = jc69_transition(torch.tensor(RANKING_LENGTH, device=dev), 4)
    uniform = torch.full((4,), 0.25, device=dev)

    def k34_on(children, leaves, weights, transition, masks, plain_reps=5) -> dict:
        def run(fn):
            return lambda: fn(children, leaves, weights, uniform, transition,
                              sequences_are_masks=masks)
        plan = k34_plan(leaves.shape[0], 4, transition.dim() == 2, masks,
                        device_limits(dev).smem_optin)
        shape = (children.shape[0], leaves.shape[0], leaves.shape[1], 4, transition.dim() == 4)
        got = measure(
            torch, run(batched_log_likelihood_cuda), run(batched_log_likelihood_plain),
            *k34_work(*shape, leaf_table=plan.leaf_table), rtol=K34_RTOL, plain_reps=plain_reps,
        )
        return dict(plan=dataclasses.asdict(plan), **got,
                    **device_times(run(batched_log_likelihood_cuda), got["ms"]),
                    bound_ms_earlier=bound_ms(*k34_work(*shape, leaf_table=False))[0])

    # (a) bench.py's K3 configuration: states 0..3, shared P(0.1).
    n, length, batch = K34_SHAPE["n_taxa"], K34_SHAPE["n_sites"], K34_SHAPE["batch"]
    k34 = k34_on(
        torch.as_tensor(random_trees(rng, n, batch), device=dev),
        torch.as_tensor(rng.integers(0, 4, (n, length)).astype(np.int32), device=dev),
        torch.ones((length,), device=dev), p_shared, False,
    )
    emit("k34", shape="a: bench.py K3, shared P", **K34_SHAPE, **k34)
    # (b) the ML NNI route's own shape: the NNI neighborhood of its start
    # tree (the stepwise tree profiled above) on 512 x 2048, masks, weights.
    ml_batch = torch.as_tensor(nni_neighbors_host(starts[0])[0], device=dev)
    k34_route = k34_on(ml_batch, pat_t, w_t, p_shared, True)
    emit("k34", shape="b: ML NNI route, shared P", n_taxa=aln.shape[0],
         n_sites=int(patterns.shape[1]), batch=int(ml_batch.shape[0]), **k34_route)
    # K5 (c): the same batch and alignment in the mask mode with pattern
    # weights (the infer-style input), under transition/transversion costs.
    tt_cost = CostModel.transition_transversion(1.0, 2.0, device=dev).matrix

    def k5_on(children, leaves, cost, weights, hamming=False, masks=False,
              plain_reps=5, reps=30, kernel=None) -> dict:
        """K5 against its plain version, bit for bit, with its plan, device
        times and its bound at the instruction rate (and the global-scratch
        version's, two messages an ancestor at the FMA-flop rate).
        ``kernel``: the call under test, when it is not the wrapper itself
        (the dispatch)."""
        def call(fn):
            return lambda: fn(children, leaves, cost, weights, hamming=hamming,
                              sequences_are_masks=masks)
        plan = k5_plan(leaves.shape[0], cost.shape[0], hamming, masks,
                       device_limits(dev).smem_optin)
        shape = (children.shape[0], leaves.shape[0], leaves.shape[1], cost.shape[0], hamming)
        kernel = kernel or call(batched_sankoff_score_cuda)
        got = measure(torch, kernel, call(batched_sankoff_score_plain),
                      *k5_work(*shape, leaf_table=plan.leaf_table),
                      plain_reps=plain_reps, reps=reps, ops_per_s=F32_INSTR_PER_S)
        return dict(plan=dataclasses.asdict(plan), **got, **device_times(kernel, got["ms"]),
                    bound_ms_earlier=bound_ms(*k5_work(*shape, leaf_table=False))[0])

    k5_shapes = {}
    k5_shapes["c"] = dict(
        shape="c: masks + pattern weights, transition/transversion(1, 2)",
        n_taxa=aln.shape[0], n_sites=int(patterns.shape[1]),
        batch=int(ml_batch.shape[0]), **k5_on(ml_batch, pat_t, tt_cost, w_t, masks=True,
                                             plain_reps=2))
    emit("k5", **k5_shapes["c"])

    # 5d. The tree plan kernel against its plain version, integer for
    # integer: the ML NNI batch (512 taxa, B = 1020), the deep trees, and
    # trees too large to stage in shared memory (its global mode).
    deep = deep_inputs(torch, dev)
    wide = torch.as_tensor(random_trees(np.random.default_rng(SEED + 31), PLAN_WIDE["n_taxa"],
                                        PLAN_WIDE["batch"]), device=dev)
    plan_shapes = {}
    for key, children in (("ml nni batch", ml_batch), *((k, v[0]) for k, v in deep.items()),
                          ("wide", wide)):
        batch, n_anc, _ = children.shape
        launch = plan_launch(n_anc, device_limits(dev).smem_optin)
        used = int(tree_plan_plain(children)[..., 3].max()) + 1
        got = measure(torch, lambda children=children: tree_plan(children),
                      lambda children=children: tree_plan_plain(children),
                      *plan_work(batch, n_anc + 1), reps=10, plain_reps=1,
                      ops_per_s=INT32_OPS_PER_S)
        plan_shapes[key] = dict(
            shape=key, n_taxa=n_anc + 1, batch=batch, launch=dataclasses.asdict(launch),
            slots_used=used, slots_bound=slots_for(n_anc + 1), **got,
            **device_times(lambda children=children: tree_plan(children), got["ms"]))
        if (used > slots_for(n_anc + 1) or launch.staged != (key != "wide")):
            raise AssertionError(f"tree plan ({key}): {plan_shapes[key]}")
        emit("tree_plan", **plan_shapes[key])
    del ml_batch, wide
    # (c) per-branch P, JC lengths U(0.05, 1.0); states with 5% missing
    # (negative), so state mode's missing data is held against the plain
    # version too.
    n, length, batch = (K4_BRANCH_SHAPE[k] for k in ("n_taxa", "n_sites", "batch"))
    lengths = torch.as_tensor(
        rng.uniform(0.05, 1.0, (batch, 2 * n - 1)).astype(np.float32), device=dev)
    states = rng.integers(0, 4, (n, length)).astype(np.int32)
    states[rng.random((n, length)) < 0.05] = -1
    k34_branch = k34_on(
        torch.as_tensor(random_trees(rng, n, batch), device=dev),
        torch.as_tensor(states, device=dev),
        torch.ones((length,), device=dev), jc69_transition(lengths, 4).contiguous(), False,
    )
    emit("k34", shape="c: per-branch P, 5% missing states", **K4_BRANCH_SHAPE,
         **k34_branch)
    k34_deep = {}
    for key, (children, leaves, weights) in deep.items():
        k34_deep[key] = dict(shape=f"{key}: shared P", **DEEP_SHAPE, **k34_on(
            children, leaves, weights, p_shared, False, plain_reps=1))
        emit("k34", **k34_deep[key])

    # 6. NNI route: candidate batches through K1.
    nni_fasta = os.path.join(workdir, "nni.fasta")
    simulate_fasta(nni_fasta, NNI_SHAPE["n_taxa"], NNI_SHAPE["n_sites"], SEED + 2)
    reset_counts()
    t0 = time.perf_counter()
    nni_argv = ["infer", "--alignment", nni_fasta, "--neighborhood", "nni", "--rounds", "20"]
    nni = run_cli(nni_argv)
    torch.cuda.synchronize()
    nni_wall = time.perf_counter() - t0
    nni_k1 = batched_fitch_score_cuda.launches
    nni_k2 = insertion_delta_cuda.launches
    if nni_k1 <= 0:
        raise AssertionError("the NNI route launched no Fitch kernel")
    # K1 at the route's own shape: the NNI neighborhood of its result.
    _, nni_aln, _ = _load_alignment(nni_fasta, "dna")
    nni_pat, nni_counts = compress_alignment(nni_aln)
    k1_nni = k1_on(
        torch.as_tensor(nni_neighbors_host(nni.result.topology)[0], device=dev),
        torch.as_tensor(nni_pat.astype(np.int32), device=dev),
        torch.as_tensor(nni_counts.astype(np.float32), device=dev),
    )
    emit("nni_route", command="infer --neighborhood nni --rounds 20",
         n_taxa=nni.out["n_taxa"], unique_patterns=nni.out["unique_patterns"],
         parsimony_score=nni.out["parsimony_score"],
         search_rounds=nni.out["search_rounds"], evaluations=nni.out["evaluations"],
         stepwise_s=nni.seconds["start"], climb_s=nni.seconds["climb"],
         wall_s=nni_wall, k1_launches=nni_k1, k2_launches=nni_k2,
         k1_at_this_shape=k1_nni)
    emit("profile", part="NNI route (the whole infer)",
         **profile_phase(torch, lambda: run_cli(nni_argv), nni_wall))

    # 6b. ML NNI route on the main path's alignment: candidate batches
    # ranked by K3/K4, then the Newton fit.
    reset_counts()
    t0 = time.perf_counter()
    ml = run_cli(["infer", "--alignment", main_fasta, "--criterion", "ml",
                  "--neighborhood", "nni", "--rounds", "10"])
    torch.cuda.synchronize()
    ml_wall = time.perf_counter() - t0
    ml_launches = launch_counts()
    ml_calls = call_counts()
    if ml_launches["k34"] <= 0 or ml_launches["k2"] <= 0 or ml_launches["plan"] <= 0:
        raise AssertionError(f"the ML NNI route skipped a kernel: {ml_launches}")
    # The returned tree rescored at P(0.1) by the kernel and by the plain
    # version must both give the reported ranking score.
    ml_tree = ml.result.topology.children[None].contiguous()
    rescored = {
        name: -float(fn(ml_tree, pat_t, w_t, uniform, p_shared, sequences_are_masks=True)[0])
        for name, fn in (("kernel", batched_log_likelihood_cuda),
                         ("plain", batched_log_likelihood_plain))
    }
    for name, value in rescored.items():
        if abs(value - ml.out["ranking_score"]) > 1e-5 * abs(ml.out["ranking_score"]):
            raise AssertionError(
                f"{name} rescoring {value} != reported {ml.out['ranking_score']}")
    if not np.isfinite(ml.out["neg_log_likelihood"]) or ml.out["neg_log_likelihood"] <= 0:
        raise AssertionError(f"bad ML result {ml.out}")
    emit("ml_nni_route", command="infer --criterion ml --neighborhood nni --rounds 10",
         n_taxa=ml.out["n_taxa"], n_sites=ml.out["n_sites"],
         unique_patterns=ml.out["unique_patterns"],
         neg_log_likelihood=ml.out["neg_log_likelihood"],
         ranking_score=ml.out["ranking_score"],
         mean_branch_length=ml.out["mean_branch_length"],
         search_rounds=ml.out["search_rounds"], evaluations=ml.out["evaluations"],
         stepwise_s=ml.seconds["start"], climb_s=ml.seconds["climb"],
         newton_s=ml.seconds["newton"], wall_s=ml_wall,
         k1_launches=ml_launches["k1"], k2_launches=ml_launches["k2"],
         k34_launches=ml_launches["k34"], k34_calls=ml_calls["k34"],
         plan_launches=ml_launches["plan"], rescored=rescored)

    # 6c. Where the ML NNI route's time goes: its climb and its Newton fit.
    climbed = []
    emit("profile", part="ML NNI climb (10 rounds)", **profile_phase(
        torch,
        lambda: climbed.append(ml_hill_climb(
            starts[0], pat_t, n_states, max_rounds=10, neighborhood="nni",
            optimize_final_lengths=False, sequences_are_masks=True,
            site_weights=w_t)[0]),
        ml.seconds["climb"]))
    if not torch.equal(climbed[0].topology.children, ml.result.topology.children):
        raise AssertionError("the profiled ML climb returned another tree")
    emit("profile", part="ML Newton fit (12 sweeps)", **profile_phase(
        torch,
        lambda: optimize_branch_lengths_newton(
            climbed[0].topology, pat_t, n_states, site_weights=w_t,
            sequences_are_masks=True, init_length=RANKING_LENGTH),
        ml.seconds["newton"]))
    del starts, climbed

    # 6d. The default ML route (analytic SPR scan, plain torch) at a reduced
    # size: its scan rounds are launch-bound Python loops.
    scan_fasta = os.path.join(workdir, "ml_scan.fasta")
    simulate_fasta(scan_fasta, ML_SCAN_SHAPE["n_taxa"], ML_SCAN_SHAPE["n_sites"], SEED + 4)
    reset_counts()
    t0 = time.perf_counter()
    scan = run_cli(["infer", "--alignment", scan_fasta, "--criterion", "ml",
                    "--rounds", "5"])
    torch.cuda.synchronize()
    scan_wall = time.perf_counter() - t0
    if not np.isfinite(scan.out["neg_log_likelihood"]):
        raise AssertionError(f"bad ML scan result {scan.out}")
    emit("ml_scan_route", command="infer --criterion ml --rounds 5",
         reduced="128 x 1024 and 5 rounds, not the main path's 512 x 2048: "
                 "the plain-torch scan is launch-bound",
         n_taxa=scan.out["n_taxa"], unique_patterns=scan.out["unique_patterns"],
         neg_log_likelihood=scan.out["neg_log_likelihood"],
         ranking_score=scan.out["ranking_score"],
         search_rounds=scan.out["search_rounds"], evaluations=scan.out["evaluations"],
         stepwise_s=scan.seconds["start"], climb_s=scan.seconds["climb"],
         newton_s=scan.seconds["newton"], wall_s=scan_wall,
         k1_launches=batched_fitch_score_cuda.launches,
         k2_launches=insertion_delta_cuda.launches,
         k34_launches=batched_log_likelihood_cuda.launches)

    # 6e. K5 against its plain version, bit for bit, at its other shapes.
    # (a) bench.py's shape under transition/transversion(1, 2) costs.
    n, length, batch = (K5_BENCH_SHAPE[k] for k in ("n_taxa", "n_sites", "batch"))
    trees = torch.as_tensor(random_trees(rng, n, batch), device=dev)
    states = torch.as_tensor(rng.integers(0, 4, (n, length)).astype(np.int32), device=dev)
    ones = torch.ones((length,), device=dev)
    k5 = k5_on(trees, states, tt_cost, ones)
    k5_shapes["a"] = dict(shape="a: bench.py's shape, transition/transversion(1, 2)",
                          **K5_BENCH_SHAPE, **k5)
    emit("k5", **k5_shapes["a"])
    # (f) the closed-form Hamming mode on the same trees and states, with K1
    # on them (as singleton masks) beside it.
    hamming4 = CostModel.hamming(4, device=dev).matrix
    k5_shapes["f"] = dict(shape="f: closed-form Hamming, Q = 4", **K5_BENCH_SHAPE,
                          **k5_on(trees, states, hamming4, ones, hamming=True),
                          k1_same_inputs=k1_on(trees, torch.ones_like(states) << states, ones))
    emit("k5", **k5_shapes["f"])
    del trees
    # (d) protein-sized Q = 20 under a seeded asymmetric integer cost 0..3.
    n, length, batch, q = K5_Q20_SHAPE.values()
    q20_cost = asymmetric_cost(rng, q)
    k5_shapes["d"] = dict(shape="d: Q = 20, asymmetric integer cost", **K5_Q20_SHAPE, **k5_on(
        torch.as_tensor(random_trees(rng, n, batch), device=dev),
        torch.as_tensor(rng.integers(0, q, (n, length)).astype(np.int32), device=dev),
        torch.as_tensor(q20_cost, device=dev), ones))
    emit("k5", **k5_shapes["d"])
    # (e) Hamming at Q = 61 (codons) through the dispatch: past Fitch's 32
    # states, so K5 in its general mode, on the runtime-Q kernel.
    n, length, batch, q = K5_Q61_SHAPE.values()
    trees61 = torch.as_tensor(random_trees(rng, n, batch), device=dev)
    topos61 = Topology(trees61, torch.zeros((batch, 2 * n - 1), dtype=torch.int32, device=dev))
    states61 = torch.as_tensor(rng.integers(0, q, (n, length)).astype(np.int32), device=dev)
    hamming61 = CostModel.hamming(q, device=dev).matrix
    k5_shapes["e"] = dict(
        shape="e: Hamming, Q = 61, through the dispatch (general mode)", **K5_Q61_SHAPE,
        **k5_on(trees61, states61, hamming61, ones,
                kernel=lambda: batched_scores_fastest(topos61, hamming61, states61)))
    emit("k5", **k5_shapes["e"])
    del trees61, topos61
    # The deep trees, and Q = 128 on 2048 taxa in the global-slot mode, a
    # random float cost and weights (bit for bit whatever the cost).
    for key, (children, leaves, weights) in deep.items():
        k5_shapes[key] = dict(shape=f"{key}: transition/transversion(1, 2)", **DEEP_SHAPE,
                              **k5_on(children, leaves, tt_cost, weights, plain_reps=1))
        emit("k5", **k5_shapes[key])
    n, length, batch, q = K5_GLOBAL_SHAPE.values()
    rng = np.random.default_rng(SEED + 32)
    k5_shapes["global"] = dict(
        shape="global slots: Q = 128, random float cost", **K5_GLOBAL_SHAPE, **k5_on(
            torch.as_tensor(random_trees(rng, n, batch), device=dev),
            torch.as_tensor(rng.integers(0, q, (n, length)).astype(np.int32), device=dev),
            torch.as_tensor(rng.random((q, q)).astype(np.float32) * 3, device=dev),
            torch.as_tensor(rng.random(length).astype(np.float32) * 3, device=dev),
            plain_reps=1, reps=5))
    if k5_shapes["global"]["plan"]["mode"] != "global":
        raise AssertionError(f"K5 global shape plan: {k5_shapes['global']['plan']}")
    emit("k5", **k5_shapes["global"])
    del deep

    # 6f. This slice's main path: the weighted-parsimony NNI climb at full
    # width — stepwise start (best of 4 orders; K2, K1), then
    # parsimony_hill_climb under transition/transversion(1, 2) on int32
    # states, whose candidate batches K5 scores. The climb runs under the
    # profiler (few launches per round, so its wall time is kept).
    wt_fasta = os.path.join(workdir, "weighted.fasta")
    # Longer branches than the main path's, so the stepwise start is not
    # already an NNI optimum under the weighted cost.
    simulate_fasta(wt_fasta, MAIN_SHAPE["n_taxa"], MAIN_SHAPE["n_sites"], SEED + 5,
                   branch=(0.05, 0.3), missing=0.0)
    wt_states = dna_states(wt_fasta)
    wt_t = torch.as_tensor(wt_states, device=dev)
    wt_ones = torch.ones((wt_t.shape[1],), device=dev)
    reset_counts()
    t0 = time.perf_counter()
    wt_start, wt_start_score = stepwise.stepwise_addition_multi(
        wt_states, 4, n_orders=4, seed=0, device=dev)
    torch.cuda.synchronize()
    wt_stepwise_s = time.perf_counter() - t0
    climbs = []
    wt_profile = profile_phase(torch, lambda: climbs.append(parsimony_hill_climb(
        wt_start, tt_cost, wt_t, neighborhood="nni", max_rounds=WEIGHTED_ROUNDS)), None)
    wt_wall = time.perf_counter() - t0
    wt_counts = launch_counts()
    wt_calls = call_counts()
    if (wt_counts["k5"] <= 0 or wt_counts["k2"] <= 0 or wt_counts["plan"] <= 0
            or wt_counts["k34"] != 0):
        raise AssertionError(f"weighted route launches: {wt_counts}")
    climb = climbs[0]
    # The returned tree rescored by K5 and by its plain version.
    wt_tree = climb.topology.children[None].contiguous()
    wt_rescored = {
        name: float(fn(wt_tree, wt_t, tt_cost, wt_ones, hamming=False)[0])
        for name, fn in (("kernel", batched_sankoff_score_cuda),
                         ("plain", batched_sankoff_score_plain))
    }
    if set(wt_rescored.values()) != {climb.score}:
        raise AssertionError(f"weighted climb score {climb.score} != {wt_rescored}")
    emit("weighted_route",
         command="stepwise_addition_multi(4 orders) + parsimony_hill_climb(nni, "
                 f"transition_transversion(1, 2), max_rounds={WEIGHTED_ROUNDS})",
         n_taxa=int(wt_t.shape[0]), n_sites=int(wt_t.shape[1]),
         start_unit_cost_score=wt_start_score, weighted_score=climb.score,
         rounds=climb.rounds, evaluations=climb.evaluations, trace=climb.trace,
         stepwise_s=wt_stepwise_s, climb_s=wt_profile["profiled_wall_s"], wall_s=wt_wall,
         launches=wt_counts, calls=wt_calls, rescored=wt_rescored, profile=wt_profile)
    # K5 (b): the route's own batch, the NNI neighbourhood of its start tree.
    wt_batch = torch.as_tensor(nni_neighbors_host(wt_start)[0], device=dev)
    k5_shapes["b"] = dict(
        shape="b: the weighted NNI route's batch, transition/transversion(1, 2)",
        n_taxa=int(wt_t.shape[0]), n_sites=int(wt_t.shape[1]),
        batch=int(wt_batch.shape[0]),
        **k5_on(wt_batch, wt_t, tt_cost, wt_ones, plain_reps=2))
    emit("k5", **k5_shapes["b"])
    del wt_batch, wt_start, climbs, climb

    # 6g. The score command on generated data (plain-torch Sankoff DP and
    # reconstruction on the card), its score held against K5's rescoring
    # of the same balanced tree; then bench on the codon alphabet (K5) and
    # on DNA (K1), each batch held against the plain version.
    reset_counts()
    t0 = time.perf_counter()
    scored = run_cli(SCORE_ARGS)
    torch.cuda.synchronize()
    score_wall = time.perf_counter() - t0
    score_counts = launch_counts()
    n_leaves, n_sites = int(SCORE_ARGS[2]), int(SCORE_ARGS[4])
    gt = generate_groundtruth(n_leaves, 4, 3, n_sites, seed=0, device=dev)
    balanced = balanced_topology(n_leaves, dev).children[None].contiguous()
    gt_leaves = gt.all_sequences[:n_leaves].to(torch.int32)
    gt_ones = torch.ones((n_sites,), device=dev)
    score_rescored = {
        name: float(fn(balanced, gt_leaves, hamming4, gt_ones, hamming=False)[0])
        for name, fn in (("kernel", batched_sankoff_score_cuda),
                         ("plain", batched_sankoff_score_plain))
    }
    if set(score_rescored.values()) != {scored["parsimony_score"]}:
        raise AssertionError(f"score {scored} != K5 rescoring {score_rescored}")
    emit("score", command=" ".join(SCORE_ARGS), **scored, wall_s=score_wall,
         launches=score_counts, k5_rescored=score_rescored)
    del gt, balanced, gt_leaves
    bench_runs = {}
    for n_states in (61, 4):
        argv = BENCH_ARGS + ["--states", str(n_states)]
        reset_counts()
        t0 = time.perf_counter()
        bench_out, bench_scores = run_cli(argv)
        torch.cuda.synchronize()
        bench_wall = time.perf_counter() - t0
        bench_counts = launch_counts()
        topos, cost, leaves = bench_inputs(build_parser().parse_args(argv), dev)
        ones_b = torch.ones((leaves.shape[1],), device=dev)
        if n_states > 32:
            want = batched_sankoff_score_plain(topos.children, leaves, cost, ones_b)
        else:
            want = batched_fitch_score_plain(
                topos.children, torch.ones_like(leaves) << leaves, ones_b)
        kernel = "k5" if n_states > 32 else "k1"
        if bench_counts[kernel] <= 0 or not torch.equal(bench_scores, want):
            raise AssertionError(f"bench --states {n_states}: {bench_counts}, scores differ")
        bench_runs[n_states] = dict(bench_out, wall_s=bench_wall, launches=bench_counts)
        emit("bench", command=" ".join(argv), same_scores_as_plain=True,
             **bench_runs[n_states])
        del topos, leaves, bench_scores, want

    # 6h. K6's path: the level-synchronous scorer on the balanced
    # level-order tree at shapes (a)-(f), through its entry point with the
    # alphabet given, every count set to 0 just before and read just
    # after. Then each shape held bit for bit against its plain version
    # and against K1 on the same topology (K1 also one site per word),
    # checked to reproduce itself, and timed; its CUDA graph (n_states
    # given) also shows that the call makes no host sync. (e) at 32 states
    # checks the one-site-per-word mode's global reads. Last, the split
    # over calls whose tickets and part roots lie elsewhere in their
    # buffer: (b) split at B = 1, 3, 1 and (e) at B = 1, 3, 1.
    k6_in = {key: k6_inputs(torch, dev, key) for key in "abcdef"}
    reset_counts()
    k6_path = {
        key: fitch_levels_balanced(x[0], n_leaves=K6_SHAPES[key]["n_leaves"],
                                   batch=K6_SHAPES[key]["batch"], n_states=x[3])
        for key, x in k6_in.items()
    }
    torch.cuda.synchronize()
    k6_counts = launch_counts()
    if k6_counts["k6"] != len(k6_in) or any(v for k, v in k6_counts.items() if k != "k6"):
        raise AssertionError(f"K6 path launches: {k6_counts}")
    k6_shapes = {}
    for key in "abcdef":
        shape = K6_SHAPES[key]
        n, length, batch = shape["n_leaves"], shape["n_sites"], shape["batch"]
        masks, children, ones, alphabet, used = k6_in[key]
        plain = fitch_levels_plain(masks, n, batch)
        checks = {
            "path": k6_path[key],
            "k1_plain": batched_fitch_score_plain(children, masks, ones),
            **{f"k1_{q}_states": batched_fitch_score_cuda(children, masks, ones, n_states=q)
               for q in sorted({alphabet, 32})},
            "alphabet_read": fitch_levels_balanced(masks, n_leaves=n, batch=batch),
        }
        if key == "e":
            checks["one_site_per_word"] = fitch_levels_balanced(
                masks, n_leaves=n, batch=batch, n_states=32)
            if k6_plan(batch, n, length, 32, *device_limits(dev)).staged:
                raise AssertionError("K6 (e) at 32 states: expected global reads")
        for name, got in checks.items():
            if not torch.equal(got, plain):
                raise AssertionError(f"K6 ({key}): {name} differs from the plain version")
        plan = k6_plan(batch, n, length, alphabet, *device_limits(dev))
        if (plan.mode, plan.parts) != K6_PLANS[key]:
            raise AssertionError(f"K6 ({key}) plan {plan}")

        def k6_run(masks=masks, n=n, batch=batch, q=alphabet):
            return fitch_levels_balanced(masks, n_leaves=n, batch=batch, n_states=q)

        def k1_run(q, children=children, masks=masks, ones=ones):
            return lambda: batched_fitch_score_cuda(children, masks, ones, n_states=q)

        k6_shapes[key] = dict(
            shape=key, **shape, states_used=used, k1_alphabet=alphabet,
            plan=dataclasses.asdict(plan), mode=plan.mode, split=plan.parts,
            score=float(plain[0]), equal_to_k1=True,
            **measure(torch, k6_run, lambda: fitch_levels_plain(masks, n, batch),
                      *k6_work(batch, n, length, used), ops_per_s=INT32_OPS_PER_S,
                      plain_reps=2),
            graph_ms=graph_ms(torch, k6_run),
            k1_graph_ms=graph_ms(torch, k1_run(alphabet)),
            k1_one_site_per_word_graph_ms=graph_ms(torch, k1_run(32)),
        )
        emit("k6", **k6_shapes[key])
    for key in "be":
        n, length = K6_SHAPES[key]["n_leaves"], K6_SHAPES[key]["n_sites"]
        masks = k6_in[key][0]
        for batch in (1, 3, 1):
            split = k6_sliced_plan(batch, n, length, 4, *device_limits(dev))
            got = {"split": run_k6_plan(masks, batch, split),
                   "entry": fitch_levels_balanced(masks, n_leaves=n, batch=batch, n_states=4)}
            for name, scores in got.items():
                if split.parts == 1 or not torch.equal(scores, fitch_levels_plain(masks, n, batch)):
                    raise AssertionError(f"K6 ({key}) B={batch}: {name} differs ({split})")
        emit("k6_split_sequence", shape=key, batches=[1, 3, 1], equal=True)
    del k6_in, k6_path

    # 7. Reference: on a small, divergent alignment (the climbs take rounds)
    # the card's run returns the same tree and score as the CPU run — the
    # plain versions, which the CPU tests hold against the JAX package.
    ref_fasta = os.path.join(workdir, "ref.fasta")
    simulate_fasta(ref_fasta, REF_SHAPE["n_taxa"], REF_SHAPE["n_sites"], SEED + 3,
                   branch=(0.2, 0.6))
    for neighborhood in ("spr-scan", "nni"):
        argv = ["infer", "--alignment", ref_fasta, "--neighborhood", neighborhood,
                "--orders", "1"]
        on_card = run_cli(argv).out
        on_cpu = run_cli(argv + ["--device", "cpu"]).out
        if on_card != on_cpu:
            raise AssertionError(f"{neighborhood}: card {on_card} != cpu {on_cpu}")
        emit("reference", neighborhood=neighborhood, n_taxa=REF_SHAPE["n_taxa"],
             parsimony_score=on_card["parsimony_score"],
             search_rounds=on_card["search_rounds"], same_tree_and_score=True)
        # ML: the same topology and rounds; log-likelihoods within rtol 1e-5
        # (float32 sums in another order on the card).
        argv += ["--criterion", "ml"]
        on_card = run_cli(argv).out
        on_cpu = run_cli(argv + ["--device", "cpu"]).out
        same = (
            strip_lengths(on_card["tree"]) == strip_lengths(on_cpu["tree"])
            and on_card["search_rounds"] == on_cpu["search_rounds"]
            and list(on_card) == list(on_cpu)
        )
        rel = {
            key: abs(on_card[key] - on_cpu[key]) / abs(on_cpu[key])
            for key in ("neg_log_likelihood", "ranking_score")
        }
        if not same or max(rel.values()) > 1e-5:
            raise AssertionError(f"ml {neighborhood}: card {on_card} != cpu {on_cpu}")
        emit("reference", criterion="ml", neighborhood=neighborhood,
             n_taxa=REF_SHAPE["n_taxa"], neg_log_likelihood=on_card["neg_log_likelihood"],
             ranking_score=on_card["ranking_score"],
             search_rounds=on_card["search_rounds"], same_tree=True, rel_err=rel)
    # The weighted NNI climb (from a one-order stepwise start) and
    # ``score --alignment`` with ``--output-fasta``: card and CPU identical.
    wref_fasta = os.path.join(workdir, "weighted_ref.fasta")
    simulate_fasta(wref_fasta, REF_SHAPE["n_taxa"], REF_SHAPE["n_sites"], SEED + 6,
                   branch=(0.2, 0.6), missing=0.0)
    wref = dna_states(wref_fasta)
    climbed = {}
    for device in ("cuda", "cpu"):
        start, _ = stepwise.stepwise_addition_multi(wref, 4, n_orders=1, seed=0, device=device)
        result = parsimony_hill_climb(
            start, CostModel.transition_transversion(1.0, 2.0, device=device).matrix,
            torch.as_tensor(wref, device=device), neighborhood="nni", max_rounds=50)
        climbed[device] = (result.topology.children.cpu().tolist(), result.score,
                           result.rounds, result.evaluations)
    if climbed["cuda"] != climbed["cpu"]:
        raise AssertionError(f"weighted climb: card {climbed['cuda'][1:]} != cpu {climbed['cpu'][1:]}")
    emit("reference", route="weighted nni climb, transition/transversion(1, 2)",
         n_taxa=REF_SHAPE["n_taxa"], weighted_score=climbed["cuda"][1],
         rounds=climbed["cuda"][2], evaluations=climbed["cuda"][3], same_tree_and_score=True)
    scored_on = {}
    for device in ("cuda", "cpu"):
        fasta_out = os.path.join(workdir, f"score_{device}.fasta")
        out = run_cli(["score", "--alignment", ref_fasta, "--output-fasta", fasta_out,
                       "--device", device])
        out.pop("output_fasta")
        with open(fasta_out) as fh:
            scored_on[device] = (out, fh.read())
    if scored_on["cuda"] != scored_on["cpu"]:
        raise AssertionError(f"score --alignment: card {scored_on['cuda'][0]} != cpu")
    emit("reference", command="score --alignment --output-fasta", **scored_on["cuda"][0],
         same_output_and_fasta=True)
    # Stepwise addition on masks with bits above the alphabet (bit 5 in 20%
    # of them, bit 31 in 5%): the card hands K1 every bit the masks use, so
    # its tree and score are the CPU's (which the CPU tests hold to the JAX
    # package's).
    wide = _load_alignment(ref_fasta, "dna")[1].astype(np.int64)
    wide_rng = np.random.default_rng(SEED + 7)
    wide[wide_rng.random(wide.shape) < 0.2] |= 1 << 5
    wide[wide_rng.random(wide.shape) < 0.05] |= 1 << 31
    wide = (wide - ((wide >> 31) << 32)).astype(np.int32)
    grown = {}
    for device in ("cuda", "cpu"):
        topo, score = stepwise.stepwise_addition(wide, 4, sequences_are_masks=True, seed=0,
                                                 device=device)
        grown[device] = (topo.children.cpu().tolist(), score)
    if grown["cuda"] != grown["cpu"]:
        raise AssertionError(f"stepwise on wide masks: card {grown['cuda'][1]} != cpu {grown['cpu'][1]}")
    emit("reference", route="stepwise_addition, masks with bits 5 and 31 set, n_states 4",
         n_taxa=REF_SHAPE["n_taxa"], parsimony_score=grown["cuda"][1], same_tree_and_score=True)
    shutil.rmtree(workdir)

    kernels = [
        {
            "name": "fitch_batched", "route": "cuda",
            "source": "trex_tpu_torch/csrc/fitch_batched.cu",
            "replaces": "trex_tpu/ops/sankoff_pallas.py:183",
            "launches": main_k1, "nni_route_launches": nni_k1,
            "ml_nni_route_launches": ml_launches["k1"],
            "weighted_route_launches": wt_counts["k1"],
            "bench_q4_launches": bench_runs[4]["launches"]["k1"],
            "shape": K1_SHAPE, **k1, "library_ms": None,
            "at_main_path": k1_main, "at_nni_route": k1_nni,
            "at_shapes": dict(k1_shapes, b=k1_main, c=k1_nni),
        },
        {
            "name": "insertion_delta", "route": "cuda",
            "source": "trex_tpu_torch/csrc/insertion_delta.cu",
            "replaces": "trex_tpu/ops/insertion_pallas.py:84",
            "launches": main_k2, "nni_route_launches": nni_k2,
            "ml_nni_route_launches": ml_launches["k2"],
            "weighted_route_launches": wt_counts["k2"],
            **k2, "library_ms": None, "at_shapes": k2_shapes,
        },
        {
            "name": "likelihood_batched", "route": "cuda",
            "source": "trex_tpu_torch/csrc/likelihood_batched.cu",
            "replaces": ["trex_tpu/ops/likelihood_pallas.py:255",
                         "trex_tpu/ops/likelihood_pallas.py:135"],
            # Its path is the ML NNI route; the parsimony main path runs none.
            "launches": ml_launches["k34"], "calls": ml_calls["k34"],
            "main_path_launches": main_k34, "weighted_route_launches": wt_counts["k34"],
            "shape": K34_SHAPE, **k34, "library_ms": None,
            "at_ml_nni_route": k34_route, "per_branch": k34_branch, "at_shapes": k34_deep,
        },
        {
            "name": "sankoff_batched", "route": "cuda",
            "source": "trex_tpu_torch/csrc/sankoff_batched.cu",
            "replaces": "trex_tpu/ops/sankoff_pallas.py:62",
            # Its path is the weighted NNI route; bench runs it at Q = 61.
            "launches": wt_counts["k5"], "calls": wt_calls["k5"],
            "main_path_launches": main_counts["k5"],
            "bench_q61_launches": bench_runs[61]["launches"]["k5"],
            "score_launches": score_counts["k5"],
            "shape": K5_BENCH_SHAPE, **k5, "library_ms": None,
            "at_shapes": {key: v for key, v in k5_shapes.items() if key != "a"},
        },
        {
            "name": "tree_plan", "route": "cuda",
            "source": "trex_tpu_torch/csrc/tree_plan.cu",
            # A pre-pass of the K5 and K3/K4 ports: the Pallas kernels
            # walked index order with every row in VMEM.
            "replaces": ["trex_tpu/ops/sankoff_pallas.py:62",
                         "trex_tpu/ops/likelihood_pallas.py:255",
                         "trex_tpu/ops/likelihood_pallas.py:135"],
            # Its path is every K5 and K3/K4 call: the weighted route's and
            # the ML NNI route's.
            "launches": wt_counts["plan"], "ml_nni_route_launches": ml_launches["plan"],
            "main_path_launches": main_counts["plan"],
            **plan_shapes["ml nni batch"], "library_ms": None, "at_shapes": plan_shapes,
        },
        {
            "name": "fitch_levels", "route": "cuda",
            "source": "trex_tpu_torch/csrc/fitch_levels.cu",
            "replaces": "benchmarks/fitch_levels.py:63",
            # Its path is the A/B's entry point at shapes (a)-(f); no route
            # of the CLI runs it.
            "launches": k6_counts["k6"], "main_path_launches": main_counts["k6"],
            **k6_shapes["a"], "library_ms": None, "at_shapes": k6_shapes,
        },
    ]
    emit("done", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
