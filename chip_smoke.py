#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``trex_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py                          # every phase
    python3 chip_smoke.py --phases ml_models,ml    # a subset (plus card, build)

``--phases`` takes a comma-separated subset of PHASES (default: all); a
phase brings the phases it needs (REQUIRES), ``card`` and ``build`` always
run, an unknown name exits with status 2. With a subset the kernels line
lists only the kernels those phases measured; with every phase it lists
every kernel, and the last line is the same.

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

- the differentiable core at full width: ``infer --start diff`` on the
  NNI route's 128 x 1024 alignment (8 restarts x 600 steps, projection,
  K1 ranking the projected trees, held against K1's plain version, then
  the SPR-scan climb), ``search`` (128 x 1024, steps cut to 1000, 8
  restarts), ``asr`` (128 x 1024, 3000 steps), ``nk-bench`` (32 leaves, K
  1, 2, 5, 10, lambda 0, 0.3, 3.0, ``--iterations`` cut to 100) and
  ``search-run`` (16 x 128, 1500 steps in segments of 500, stopped after 2 and resumed,
  bit-equal to an uninterrupted run), each with its wall, its launches a
  descent step and idle share (a profiled window of 100 steps) and K1's
  launches.

- slice 1b: the port's native move library (``io/native.py``,
  built with g++ from ``csrc/trex_native.cpp``; the run fails when it does
  not load), each generator timed against the Python fallback and their
  untruncated outputs compared; the NNI, weighted and ML NNI routes above
  re-timed with it, their scores held at 10726, 363001 and 491356.25 (the
  ML route's ranking score); the
  support route (``infer --ratchet 2 --decay --bootstrap 8 --outgroup``,
  512 x 2048); the enumerating routes (``--start balanced --neighborhood
  spr --rounds 10`` on 128 x 1024, ``--neighborhood tbr --rounds 5`` on
  512 x 2048, ``--neighborhood nni --constraint`` a 16-taxon clade on 128 x
  1024), each printed tree rescored by K1 and its plain version; the
  batched stepwise path at 32 states (128 x 1024), card against CPU; and
  every new flag, card against CPU, at 24 x 300.

- slice 2b (fitted models and rate heterogeneity): on an alignment
  simulated under GTR+G at 512 x 2048 (the truth in the phase line), the
  model routes ``infer --criterion ml --model gtr+g --model-rounds 1``
  with the analytic scan under the fitted +G mixture (``--rounds 3``) and
  with NNI (``--rounds 10``, K3 ranking under the fitted GTR matrix and
  prior), each with its walls (start, climb, Newton, fit, rounds), fitted
  parameters, launches, peak memory and a profiled 20-step fit (launches
  a step, idle share), and that fit profiled on a 512-taxon caterpillar
  (511 levels); K3 held at the NNI route's own batch under that
  model; the protein route (``--model empirical+g --model-file`` a
  synthetic PAML matrix, NNI, 128 x 1024, K3 at 20 states on its batch);
  ``score --criterion ml --model gtr+g --asr joint --site-rates`` on the
  scan route's tree; ``trait`` on it with a 3-state trait evolved from
  the seed; ``ml`` with its defaults (K3 ranking SPR neighbourhoods); and
  card against CPU at 24 x 300: ``infer`` under gtr+g, hky+i, jc+r3 and
  empirical on both neighbourhoods, ``score --criterion ml``, the ML ASR
  functions under one fit, and ``trait``. The scan variant runs on a
  GTR+G alignment of 128 x 1024 (its +G scan rounds cost about 28 s each
  at 512 x 2048); ``score_ml`` and ``trait`` read the NNI variant's tree.

- slice 2c (the rest of ML and distance ``infer``, ``modeltest``,
  ``partition``): the ML support route (``infer --criterion ml --start nj
  --neighborhood nni --rounds 10 --bootstrap 8`` on the main path's 512 x
  2048 alignment: the NJ start's distance matrix held card against CPU,
  the K3 climb, Newton, 8 ML bootstrap replicates whose candidate batches
  K4's per-branch mode ranks, held at replicate 0's first batch against
  its plain version, its bound, the P table's build and K3 on the same
  batch); the ML ratchet route (``--ratchet 3``, 512 x 2048, K3 held at
  its final batch); the constrained ML climb (a 16-taxon clade, 128 x
  1024, K3 held at its filtered batch); the distance route (``--criterion
  distance --bootstrap 20`` and ``--start upgma``, 512 x 2048, the
  replicates' matrices timed apart from the host agglomeration);
  ``modeltest --models jc,hky+g,gtr+g`` on the GTR+G alignment and the NNI
  model route's tree (BIC must pick gtr+g), with a profiled 20-step HKY+G
  fit; ``partition --search --models gtr,hky+g`` on two genes of 512
  sites at 128 x 1024 (the second on twice the lengths: its multiplier
  beside 2.0); each printed tree's JC ranking log-likelihood rescored by
  K3 and on the CPU; and every new flag and command card against CPU at
  24 x 300.
- Slice 4a (``--phases supports,reference_supports``): K3 held at the
  first round of the ML TBR climb on 512 x 2048 (its first 2048 of up to
  16,384 trees; the whole round timed); ``infer --criterion ml
  --neighborhood nni --alrt 1000 --ufboot 1000`` on the main path's
  alignment, with its walls by part (start, climb, Newton, each support's
  batched fit, RELL, host bookkeeping), candidates, chunks, peak memory,
  K4's per-site mode held (rows and sums, rtol 1e-5) and timed at its
  first aLRT and UFBoot chunk, and a profiled window of two batched Newton
  sweeps (launches a sweep, idle share); ``topotest --replicates 10000``
  on 8 of its trees; ``bootstrap`` at 128 x 1024 with 50 replicates and
  ``consensus``, ``treedist``, ``treeprune``, ``concord``, ``treedraw``
  and ``stats`` on the outputs; and each new flag and command card
  against CPU at 24 x 300 under the same draws.

- Slice 5 (``--phases bayes,reference_bayes``): on a 64 x 2048 alignment
  simulated down a Kingman tree, ``mcmc --runs 2 --chains 4 --proposal
  informed --informed-power 0.1 --branch-moves 2`` (the JAX package's MCMC
  benchmark point, generations cut to MCMC_GENERATIONS) with gen/s, K4's
  launches and a steady-state window (runs of 2N generations less runs
  of N, N = MCMC_WINDOW timed and PROFILED_GENERATIONS profiled: ms and
  launches a generation, idle share, top kernels); one sample block of the
  fixed-model sampler under ``torch.cuda.set_sync_debug_mode("error")``;
  short ``--proposal nni`` and ``--full-bayes`` runs (the eigensystems'
  syncs counted); a ``--checkpoint-dir``/``--stop-after`` resume, bit for
  bit against the uninterrupted run; ``date`` on the true tree, strict at
  500 generations (cut from 4,000) and relaxed under a coalescent prior
  with a calibrated clade (walls by part, gen/s, steady windows of SAMPLER_WINDOW
  generations); ``bayesfactor --models jc,gtr`` at 32 rungs (the same);
  K4 held within rtol 1e-5 at the samplers' batches
  (8 chains, 32 rungs, 8 x 4 +G categories per site) and at the informed
  neighbourhood's 992 trees beside ``nni_scan``; and each sampler on the
  card against the CPU under one draw source at 10 x 300.

- Slice 6 (``--phases simulate,dnds,reference_models``): ``simulate
  --leaves 8192 --sites 1024 --model gtr+g`` (the JAX package's scale
  harness size; the device path: wall, depth levels, a profiled run's
  launches and idle share, peak memory; composition against the model's
  frequencies, zero-length copies and invariant sites at that size) and
  ``simulate --leaves 512 --sites 2048`` (the host walk, byte-equal to the
  CPU's); ``simulate --model gy94`` at 64 taxa x 1000 codons, ``dnds`` at
  its defaults (walls by part, a profiled window of Adam steps, omega and
  kappa beside the truth) and ``dnds --model gy94+g --search`` (its fits cut
  to 300 steps); K3/K4's
  runtime-Q kernel within rtol 1e-5 of its plain version at
  Q = 61 on the fitted tree's NNI neighbourhood (one P; a P per branch), on
  a 512-taxon batch (its plan and its global-slot mode) and at Q = 5; the
  ML NNI climb at Q = 61, card against CPU; and ``simulate`` and ``dnds
  --tree`` card against CPU at 10 taxa.

- Slice 7a (``--phases mesh,reference_mesh``), the ('tree', 'site') mesh
  (``trex_tpu_torch/parallel``) at the main path's 512 x 2048, three ways,
  each against the single-device route on the card: (a) ``infer --mesh
  auto`` in this process (a 1 x 1 mesh, no process group) against
  ``--mesh 1,1``; (b) a one-rank NCCL world running the sharded functions
  (K1 and K5 batch scores, the best tree, K4 lnL, per-site rows, the
  parsimony scan's table and best move, an ML scan round at 128 x 1024);
  (c) two gloo ranks sharing the card (``mesh_worker``, a world with a
  wall limit): ``infer`` at (2, 1) and (1, 2), the ML support route at
  (1, 2) (K4 on site shards) and the supports route at (2, 1) (candidate
  fits over 'tree'), then K1, K5 and K4 on each rank's tiles at both
  meshes; walls (two processes sharing one card: not a scaling figure),
  each rank's launches, a profiled scan round a route; and the same
  routes on the card against the CPU at 24 x 300. ``reference_bayes``
  also holds the Q = 5 sampler (the runtime-Q kernel) card against CPU.

- Slice 7b (``--phases mesh_bayes``), the samplers' chains and rungs over
  the mesh's 'tree' axis at slice 5's 64 x 2048: (a) ``mcmc_sample``,
  ``mcmc_date`` and ``stepping_stone`` with ``mesh=make_mesh()`` in a
  one-rank NCCL world, each bit for bit its ``mesh=None`` run; (b) two
  gloo ranks sharing the card (``mesh_bayes_worker``): ``mcmc --runs 1
  --chains 8 --mesh 2,1`` (the MC^3 swap straddles the ranks), ``mcmc
  --runs 2 --chains 4 --mesh 2,1``, ``bayesfactor --models jc,gtr --rungs
  32 --mesh 2,1`` and ``mcmc_date`` with 8 chains at (2, 1), each against
  its single-device card run (the same JSON, samples file and dating
  arrays, exactly), with each rank's gen/s, K4 grids a generation and
  the collectives' walls; K4 held and timed at a rank's 4-chain batch.

K1 is also captured in a CUDA graph, larger calls run, and the graph
replayed (each call's scratch is its own: bit-equal to the plain version);
shape (b) is timed with a kept buffer and with the per-call one.

It also profiles the default ``infer``'s two calls (stepwise addition,
SPR-scan climb), the NNI route, the ML NNI route's two (climb, Newton fit)
and the weighted climb with ``torch.profiler`` for the device's busy and idle share
and the top kernels, and checks on small divergent alignments that the
card returns the same results as the CPU: ``infer`` for both criteria and
both neighborhoods, the weighted climb, ``score --alignment``, stepwise
addition on masks with bits above the alphabet, and the differentiable
core (50 steps of ``joint_optimize``, ``project_topology``,
``soft_sankoff_score`` and its gradients, ``evolve_tree`` on the same
draws).

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
import math
import os
import re
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
# fuses.
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


_STARTED = time.perf_counter()


def emit(phase: str, **fields) -> None:
    """One JSON line, with the script's seconds so far (``at_s``)."""
    print(json.dumps({"phase": phase, "at_s": time.perf_counter() - _STARTED, **fields}),
          flush=True)


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


def k1_plain_in_slices(torch, children, masks, weights, budget_bytes: int = 1 << 32):
    """K1's plain version in slices of trees whose (trees x nodes x sites)
    int32 state table fits in ``budget_bytes`` (one slice for every fixed
    shape; the enumerating routes' batches need several), scores
    concatenated: each tree's score is its own."""
    from trex_tpu_torch.ops.fitch_cuda import batched_fitch_score_plain

    per_tree = (2 * children.shape[1] + 1) * masks.shape[1] * 4
    step = max(1, budget_bytes // per_tree)
    return torch.cat([batched_fitch_score_plain(children[i:i + step], masks, weights)
                      for i in range(0, children.shape[0], step)])


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


def k34_work(batch: int, n_taxa: int, n_sites: int, q: int, per_branch: bool):
    """K3/K4's (bytes, float32 ops): children, leaves, weights, prior and P
    in, scores out; per site 2Q^2 (Q^2 FMAs) for each child message the
    function needs, Q for the combine, 2Q for the max and the scale per
    ancestor. Under one shared P a leaf's message is the same in every
    tree, so the function needs each tree's n_taxa - 2 ancestor children's
    messages and the n_taxa leaves' once for the batch; with a P per branch
    and tree, all 2(n_taxa - 1) of every tree."""
    p_floats = batch * (2 * n_taxa - 1) * q * q if per_branch else q * q
    n_bytes = 4.0 * (
        batch * (n_taxa - 1) * 2 + n_taxa * n_sites + n_sites + q + p_floats + batch
    )
    messages = batch * 2 * (n_taxa - 1) if per_branch else batch * (n_taxa - 2) + n_taxa
    return n_bytes, float(n_sites * (messages * 2 * q * q + batch * (n_taxa - 1) * 3 * q))


def k5_work(batch: int, n_taxa: int, n_sites: int, q: int, hamming: bool):
    """K5's (bytes, float32 ops): children, leaves, cost and weights in,
    scores out; per site Q^2 x (add + min) for each general child message
    the function needs (Hamming: Q - 1 mins, 1 add, Q mins), Q adds per
    ancestor to combine two messages, a Q - 1 min and the weight multiply
    per tree. The cost is shared, so a leaf's message is the same in every
    tree: each tree's n_taxa - 2 ancestor children's messages and the
    n_taxa leaves' once for the batch."""
    n_bytes = 4.0 * (batch * (n_taxa - 1) * 2 + n_taxa * n_sites + q * q + n_sites + batch)
    per_message = 2 * q if hamming else 2 * q * q
    messages = batch * (n_taxa - 2) + n_taxa
    return n_bytes, float(n_sites * (messages * per_message + batch * ((n_taxa - 1) * q + q)))


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


def run_cli(argv: list[str], **kwargs):
    """A command in this process, ``kwargs`` passed to its ``run_*``
    function; returns what that function returns (``infer``: InferRun;
    ``bench``, ``search-run``, ``ml``, ``bootstrap``, ``topotest``: the
    JSON object and the scores, params, inputs, replicate trees or test
    result; ``treedraw``: its text; else the JSON object, ``partition``
    and ``modeltest`` too)."""
    from trex_tpu_torch.cli import build_parser
    from trex_tpu_torch.cli.infer import run_infer
    from trex_tpu_torch.cli.bayes import run_bayesfactor, run_concord, run_date, run_mcmc
    from trex_tpu_torch.cli.score import run_asr, run_score, run_stats, run_trait, run_treedraw
    from trex_tpu_torch.cli.search_cmds import (
        run_bench,
        run_bootstrap,
        run_ml,
        run_nk_bench,
        run_search,
        run_search_run,
    )
    from trex_tpu_torch.cli.trees import (
        run_consensus,
        run_topotest,
        run_treedist,
        run_treeprune,
    )

    from trex_tpu_torch.cli.models import run_dnds, run_modeltest, run_partition
    from trex_tpu_torch.cli.simulate import run_simulate

    run = {"infer": run_infer, "score": run_score, "bench": run_bench, "search": run_search,
           "asr": run_asr, "nk-bench": run_nk_bench, "search-run": run_search_run,
           "ml": run_ml, "trait": run_trait, "partition": run_partition,
           "modeltest": run_modeltest, "bootstrap": run_bootstrap, "topotest": run_topotest,
           "treedist": run_treedist, "consensus": run_consensus, "treeprune": run_treeprune,
           "treedraw": run_treedraw, "stats": run_stats, "concord": run_concord,
           "mcmc": run_mcmc, "date": run_date, "bayesfactor": run_bayesfactor,
           "simulate": run_simulate, "dnds": run_dnds}[argv[0]]
    with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(io.StringIO()):
        return run(build_parser().parse_args(argv), **kwargs)


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
    events, wall = device_events(torch, fn)
    if unprofiled_wall is None:
        unprofiled_wall = wall
    busy = sum(seconds for _, seconds in events.values())
    return {
        "profiled_wall_s": wall, "unprofiled_wall_s": unprofiled_wall,
        "device_busy_s": busy, "idle_share": 1.0 - busy / unprofiled_wall,
        "device_launches": sum(count for count, _ in events.values()),
        "top": top_events(events),
    }


def device_events(torch, fn) -> tuple[dict, float]:
    """({kernel or copy name: (launches, device seconds)}, wall seconds)
    of ``fn()`` under ``torch.profiler``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return ({e.key: (int(e.count), e.self_device_time_total / 1e6)
             for e in prof.key_averages() if e.device_type == DeviceType.CUDA}, wall)


def top_events(events: dict, n: int = 8) -> list[dict]:
    """The ``n`` names of ``events`` ({name: (launches, device seconds)})
    with the most device time."""
    top = sorted(events.items(), key=lambda kv: kv[1][1], reverse=True)[:n]
    return [{"name": name[:80], "count": count, "device_s": seconds}
            for name, (count, seconds) in top]


# The differentiable core's routes at full width: ``infer --start diff`` on
# the NNI route's 128 x 1024 alignment, then ``search``, ``asr``,
# ``nk-bench`` (the reference's sweep, iterations cut) and ``search-run``
# (stopped after 2 segments and resumed).
# ``search`` cut from 3000 to 1500 iterations, ``nk-bench`` from 300 to 150
# and ``search-run`` from 2000 to 1500, to make room for the models and
# simulation phases; ``search`` to 1000 and ``nk-bench`` to 100 for the
# samplers' mesh phase (on a slow host the whole script passed 1200 s).
SEARCH_ARGS = ["search", "--leaves", "128", "--sites", "1024", "--iterations", "1000"]
ASR_ARGS = ["asr", "--leaves", "128", "--sites", "1024"]
NK_ITERATIONS, NK_LEAVES, NK_SITES = 100, 32, 128
NK_ARGS = ["nk-bench", "--leaves", str(NK_LEAVES), "--sites", str(NK_SITES),
           "--k-values", "1", "2", "5", "10", "--lambdas", "0", "0.3", "3.0",
           "--iterations", str(NK_ITERATIONS)]
SEARCH_RUN_ARGS = ["search-run", "--leaves", "16", "--sites", "128", "--iterations", "1500",
                   "--checkpoint-every", "500"]
# Descent steps profiled for each route's launches a step and idle share.
WINDOW_STEPS = 100


def descent_window(torch, fn, steps: int) -> dict:
    """``profile_phase`` of ``fn()``, a run of ``steps`` descent steps, its
    unprofiled wall taken just before; with the device launches a step."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    prof = profile_phase(torch, fn, time.perf_counter() - t0)
    return dict(prof, steps=steps, launches_per_step=prof["device_launches"] / steps)


def timed_cli(torch, argv: list[str], **kwargs):
    """(result, wall seconds) of a command run on the card (``kwargs`` to
    its ``run_*`` function)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run_cli(argv, **kwargs)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def differentiable_routes(torch, dev, workdir: str, diff_fasta: str, reset_counts,
                          launch_counts) -> dict:
    """The five routes of the differentiable core, each with every launch
    count set to 0 just before it and read just after: wall, launches a
    descent step and idle share (a window of ``WINDOW_STEPS`` steps at the
    route's width under the profiler; the diff route's
    start too), and K1's launches. Returns K1's diff-route launches and the
    route records."""
    from trex_tpu_torch.alignment import compress_alignment
    from trex_tpu_torch.cli._common import (
        _load_alignment,
        diff_start,
        lowest_states,
        one_hot_leaves,
    )
    from trex_tpu_torch.models.mutation_tree import generate_groundtruth
    from trex_tpu_torch.models.nk import make_landscape
    from trex_tpu_torch.ops.fitch_cuda import batched_fitch_score_plain
    from trex_tpu_torch.search.asr import (
        reconstruct_ancestors,
        reconstruct_ancestors_landscape_aware,
    )
    from trex_tpu_torch.search.joint import JointConfig, init_params, joint_optimize, joint_search
    from trex_tpu_torch.search.runner import RunnerConfig, run_search
    from trex_tpu_torch.topology import balanced_topology, topology_to_adjacency
    from trex_tpu_torch.types import CostModel

    routes = {}
    # infer --start diff: 8 restarts x 600 steps, projection, K1 ranking,
    # then the default SPR-scan climb.
    diff_argv = ["infer", "--alignment", diff_fasta, "--start", "diff"]
    reset_counts()
    run, wall = timed_cli(torch, diff_argv)
    counts = launch_counts()
    if counts["k1"] <= 0 or any(counts[k] for k in ("k2", "k34", "k5", "k6", "plan")):
        raise AssertionError(f"diff route launches: {counts}")
    # The ranking again: K1's scores of the eight projected trees against
    # the plain version's.
    _, masks, n_states = _load_alignment(diff_fasta, "dna")
    patterns, pattern_counts = compress_alignment(masks)
    patterns = np.asarray(patterns, dtype=np.int32)
    weights = torch.as_tensor(pattern_counts, dtype=torch.float32, device=dev)
    def start():
        result = diff_start(patterns, n_states, 0, weights, dev)
        torch.cuda.synchronize()
        return result

    ranked, start_wall = timed(start)
    plain = batched_fitch_score_plain(ranked.trees.children, torch.as_tensor(patterns, device=dev),
                                      weights)
    if not torch.equal(ranked.scores, plain):
        raise AssertionError(f"K1 on the projected trees {ranked.scores} != plain {plain}")
    n_leaves, length = patterns.shape
    leaf_tensor = one_hot_leaves(
        torch.as_tensor(lowest_states(patterns, n_states), device=dev), n_states)
    init = init_params(n_leaves, length, n_states, batch=(8,),
                       generator=torch.Generator(dev).manual_seed(0))
    window = descent_window(torch, lambda: joint_optimize(
        init, leaf_tensor, JointConfig(n_iterations=WINDOW_STEPS)), WINDOW_STEPS)
    routes["diff"] = dict(
        command=" ".join(diff_argv[:1] + diff_argv[3:]) + " (128 x 1024 alignment)",
        parsimony_score=run.out["parsimony_score"], search_rounds=run.out["search_rounds"],
        start_s=run.seconds["start"], climb_s=run.seconds["climb"], wall_s=wall,
        launches=counts, k1_launches=counts["k1"], projected_scores=ranked.scores.tolist(),
        k1_equal_to_plain=True, descent_window=window,
        # The start alone: the climb is the main path's SPR scan, profiled
        # there, and tracing its 100 rounds' 620,000 launches took about
        # 100 s of the script.
        start_profile=profile_phase(torch, start, start_wall))
    emit("diff_route", **routes["diff"])

    # search: 8 restarts x 3000 steps on a generated 128-leaf tree.
    reset_counts()
    out, wall = timed_cli(torch, SEARCH_ARGS)
    counts = launch_counts()
    n_leaves, length = int(SEARCH_ARGS[2]), int(SEARCH_ARGS[4])
    gt = generate_groundtruth(n_leaves, 4, 3, length, seed=0, device=dev)
    leaf = gt.all_sequences[:n_leaves].to(torch.int32)
    leaf_tensor = one_hot_leaves(leaf, 4)
    hamming = CostModel.hamming(4, device=dev).matrix
    window = descent_window(torch, lambda: joint_search(
        leaf_tensor, hamming, JointConfig(n_iterations=WINDOW_STEPS),
        generator=torch.Generator(dev).manual_seed(0)), WINDOW_STEPS)
    if not all(np.isfinite(v) for v in out.values()):
        raise AssertionError(f"search: {out}")
    routes["search"] = dict(command=" ".join(SEARCH_ARGS), **out, wall_s=wall,
                            launches=counts, k1_launches=counts["k1"], descent_window=window)
    emit("search_route", **routes["search"])

    # asr: 3000 Adam steps of the 127 ancestors.
    reset_counts()
    out, wall = timed_cli(torch, ASR_ARGS)
    counts = launch_counts()
    window = descent_window(torch, lambda: reconstruct_ancestors(
        leaf, 2 * n_leaves - 1, 4, gt.adjacency, torch.Generator(dev).manual_seed(0),
        n_iterations=WINDOW_STEPS, learning_rate=1e-2), WINDOW_STEPS)
    if not 0.0 <= out["gradient_asr_identity"] <= 1.0:
        raise AssertionError(f"asr: {out}")
    routes["asr"] = dict(command=" ".join(ASR_ARGS), **out, wall_s=wall, launches=counts,
                         k1_launches=counts["k1"], descent_window=window)
    emit("asr_route", **routes["asr"])
    del gt, leaf_tensor, leaf

    # nk-bench: the reference's sweep, K 1, 2, 5, 10 x lambda 0, 0.3, 3.0.
    reset_counts()
    out, wall = timed_cli(torch, NK_ARGS)
    counts = launch_counts()
    generator = torch.Generator(dev).manual_seed(0)
    landscape = make_landscape(NK_SITES, 10, generator)
    topo = balanced_topology(NK_LEAVES, dev)
    leaf = torch.randint(0, 2, (NK_LEAVES, NK_SITES), generator=generator, device=dev)
    window = descent_window(torch, lambda: reconstruct_ancestors_landscape_aware(
        leaf, 2 * NK_LEAVES - 1, 2, landscape, 3.0, topology_to_adjacency(topo), generator,
        n_iterations=WINDOW_STEPS), WINDOW_STEPS)
    routes["nk_bench"] = dict(
        command=" ".join(NK_ARGS), reduced=f"--iterations {NK_ITERATIONS}, not 10000",
        results=out, wall_s=wall, launches=counts, k1_launches=counts["k1"],
        descent_window=dict(window, shape=f"K = 10, lambda = 3.0, {NK_LEAVES} x {NK_SITES}"))
    emit("nk_bench_route", **routes["nk_bench"])

    # search-run: 2000 steps in segments of 500; one run stopped after 2
    # segments and resumed by the command, one without a stop: bit-equal.
    stopped = os.path.join(workdir, "search_run_stopped")
    whole = os.path.join(workdir, "search_run_whole")
    reset_counts()
    t0 = time.perf_counter()
    n_leaves, length, steps, every = (int(SEARCH_RUN_ARGS[i]) for i in (2, 4, 6, 8))
    gt = generate_groundtruth(n_leaves, 4, 3, length, seed=0, device=dev)
    cfg = RunnerConfig(stopped, steps, every, seed=0,
                       joint=JointConfig(n_iterations=steps, learning_rate=0.01))
    run_search(cfg, one_hot_leaves(gt.all_sequences[:n_leaves].to(torch.int32), 4),
               max_segments=2)
    (out, resumed), _ = timed_cli(torch, SEARCH_RUN_ARGS + ["--workdir", stopped])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    (_, uninterrupted), whole_wall = timed_cli(torch, SEARCH_RUN_ARGS + ["--workdir", whole])
    for k in resumed:
        if not torch.equal(resumed[k], uninterrupted[k]):
            raise AssertionError(f"search-run: resumed {k} differs from the uninterrupted run")
    window = descent_window(torch, lambda: run_cli(
        SEARCH_RUN_ARGS[:6] + [str(WINDOW_STEPS), "--checkpoint-every", str(WINDOW_STEPS),
                               "--no-resume", "--workdir", os.path.join(workdir, "window")]),
        WINDOW_STEPS)
    shutil.rmtree(os.path.join(workdir, "window"))
    routes["search_run"] = dict(
        command=" ".join(SEARCH_RUN_ARGS), **out, stopped_after_segments=2,
        resumed_equal_to_uninterrupted=True, wall_s=wall, uninterrupted_wall_s=whole_wall,
        launches=counts, k1_launches=counts["k1"], descent_window=window)
    emit("search_run_route", **routes["search_run"])
    return routes


def differentiable_reference(torch, devices=("cuda", "cpu")) -> dict:
    """Card against CPU at a small size, on the same inputs: 50 steps of
    ``joint_optimize`` (2 restarts; params within atol 1e-4, losses rtol
    1e-4), ``project_topology`` (the same trees), ``soft_sankoff_score``
    (rtol 1e-5) and its gradients in the cost, leaf costs and T (within
    1e-5 of each gradient's largest entry) and ``evolve_tree`` on the same
    draws (equal)."""
    from trex_tpu_torch.models.nk import EdgeDraws, draw_edges, evolve_tree, make_landscape
    from trex_tpu_torch.ops.relax import project_topology, soft_topology
    from trex_tpu_torch.ops.soft_dp import soft_sankoff_score
    from trex_tpu_torch.search.joint import JointConfig, joint_optimize
    from trex_tpu_torch.topology import from_numpy, parents_from_children

    rng = np.random.default_rng(SEED + 40)
    n_leaves, length, q, restarts, steps = 12, 48, 4, 2, 50
    n_all = 2 * n_leaves - 1
    leaf = np.zeros((n_all, length, q), np.float32)
    leaf[np.arange(n_leaves)[:, None], np.arange(length), rng.integers(0, q, (n_leaves, length))] = 1
    init = {"tree_params": rng.normal(size=(restarts, n_all - 1, n_leaves - 1)),
            "ancestors": rng.normal(size=(restarts, n_leaves - 1, length, q))}
    noise = rng.gumbel(size=(steps, restarts, n_all - 1, n_leaves - 1))
    children = random_trees(rng, n_leaves, 1)[0]
    parents = parents_from_children(children)
    cost = rng.integers(0, 3, (q, q)).astype(np.float32)
    np.fill_diagonal(cost, 0)
    leaf_costs = rng.random((n_leaves, q, length)) * 3
    adjacency = soft_topology(torch.as_tensor(init["tree_params"], dtype=torch.float32), 0.05,
                              noise=torch.as_tensor(noise[0], dtype=torch.float32))
    got = {}
    cpu_gen = torch.Generator().manual_seed(SEED)
    landscape = make_landscape(length, 3, cpu_gen)
    draws = draw_edges(n_all, 2, length, 2, cpu_gen)
    root = torch.randint(0, 2, (length,), generator=cpu_gen)
    for device in devices:
        as_t = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)  # noqa: E731
        params, losses = joint_optimize({k: as_t(v) for k, v in init.items()}, as_t(leaf),
                                        JointConfig(n_iterations=steps), noise=as_t(noise))
        topo = project_topology(adjacency.to(device))
        c, lc, t = (as_t(x).requires_grad_(True) for x in (cost, leaf_costs, 0.3))
        score = soft_sankoff_score(from_numpy(children, parents, device), c, lc, t)
        score.backward()
        moved = evolve_tree(
            dataclasses.replace(landscape, interactions=landscape.interactions.to(device),
                                tables=landscape.tables.to(device)),
            from_numpy(children, parents, device), root.to(device), 0.2,
            draws=EdgeDraws(*(d.to(device) for d in draws)), branch_length=2)
        got[device] = dict(params={k: v.cpu() for k, v in params.items()}, losses=losses.cpu(),
                           children=topo.children.cpu(), parents=topo.parents.cpu(),
                           score=score.detach().cpu(), grads=[x.grad.cpu() for x in (c, lc, t)],
                           evolved=moved.cpu())
    card, cpu = (got[d] for d in devices)
    err = {k: float((card["params"][k] - cpu["params"][k]).abs().max()) for k in card["params"]}
    loss_rel = float(((card["losses"] - cpu["losses"]).abs() / cpu["losses"].abs()).max())
    score_rel = float(abs(card["score"] - cpu["score"]) / abs(cpu["score"]))
    # Gradients: the largest difference over the largest CPU value.
    grad_rel = [float((a - b).abs().max() / b.abs().max())
                for a, b in zip(card["grads"], cpu["grads"])]
    if (max(err.values()) > 1e-4 or loss_rel > 1e-4 or score_rel > 1e-5 or max(grad_rel) > 1e-5
            or not torch.equal(card["children"], cpu["children"])
            or not torch.equal(card["parents"], cpu["parents"])
            or not torch.equal(card["evolved"], cpu["evolved"])):
        raise AssertionError(f"differentiable core, card vs CPU: params {err}, losses {loss_rel}, "
                             f"soft DP {score_rel} {grad_rel}")
    return dict(joint_optimize_param_abs_err=err, joint_optimize_loss_rel_err=loss_rel,
                soft_sankoff_rel_err=score_rel, soft_sankoff_grad_rel_err=grad_rel,
                same_projected_trees=True, same_evolved_sequences=True)


# Slice 1b: the three NNI routes' scores, which the native generator
# must not move, and the new routes' shapes.
# (The ML NNI route's ranking score; its fitted NLL was 447808.125.)
NNI_ROUTE_SCORE, WEIGHTED_ROUTE_SCORE, ML_NNI_ROUTE_RANKING = 10726.0, 363001.0, 491356.25
SUPPORT_ARGS = ["--ratchet", "2", "--decay", "--bootstrap", "8"]
SPR_ROUNDS, TBR_ROUNDS, TBR_BUDGET = 10, 5, 16384
CONSTRAINT_TAXA = 16
BATCHED_STEPWISE_TAXA = 64
BALANCED_REF = dict(n_taxa=32, n_sites=300)


def random_canonical_tree(n_taxa: int, seed: int) -> np.ndarray:
    """Canonical children of a random coalescent tree (the numbering the
    move generators take and emit)."""
    from trex_tpu_torch.io import canonicalize_topology

    return canonicalize_topology(random_trees(np.random.default_rng(seed), n_taxa, 1)[0])[0]


def timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def native_phase() -> dict:
    """The port's native move library: built from the checkout's copy and
    loaded (the phase fails otherwise), then each generator timed against
    the Python fallback, Python only where it takes a few seconds; the
    untruncated NNI, SPR and TBR outputs compared."""
    from trex_tpu_torch.io import fallback, native

    (loaded, build_s) = timed(native.available)
    if not loaded:
        raise AssertionError(f"the native library did not load: {native.BUILD_ERROR}")
    rows = []
    cases = [
        ("nni", 128, native.nni_neighbors, fallback.py_nni_neighbors),
        ("nni", 512, native.nni_neighbors, fallback.py_nni_neighbors),
        ("spr", 48, native.spr_neighborhood, fallback.py_spr_neighborhood),
        ("spr", 128, native.spr_neighborhood, None),
        ("tbr untruncated", 32, lambda c: native.tbr_neighborhood(c, 200_000, 1),
         lambda c: fallback.py_tbr_neighborhood(c, 200_000, 1)),
        (f"tbr budget {TBR_BUDGET}", 128, lambda c: native.tbr_neighborhood(c, TBR_BUDGET, 1),
         None),
        (f"tbr budget {TBR_BUDGET}", 512, lambda c: native.tbr_neighborhood(c, TBR_BUDGET, 1),
         None),
    ]
    for move, n_taxa, fast, slow in cases:
        children = random_canonical_tree(n_taxa, SEED + n_taxa)
        (got, native_s) = timed(lambda: [x.copy() for x in fast(children)])
        row = dict(moves=move, n_taxa=n_taxa, trees=int(got[0].shape[0]), native_s=native_s)
        if slow is not None:
            (want, python_s) = timed(lambda: slow(children))
            if move.startswith("tbr"):
                same = sorted(c.tobytes() for c in got[0]) == sorted(c.tobytes() for c in want[0])
            else:
                same = all(np.array_equal(a, b) for a, b in zip(got, want))
            if not same:
                raise AssertionError(f"native {move} at {n_taxa} taxa differs from Python")
            row.update(python_s=python_s, speedup=python_s / native_s,
                       equal_to_python="as sets" if move.startswith("tbr") else "tree for tree")
        rows.append(row)
    return dict(library=str(native.library_path().relative_to(os.getcwd())),
                build_and_load_s=build_s, generators=rows)


def cherry_outgroup(topology, patterns: np.ndarray, counts: np.ndarray, names) -> str:
    """The cherry of ``topology`` whose two taxa differ at the fewest
    (weighted) sites: an outgroup that any climb from it keeps."""
    children = topology.children.cpu().numpy()
    n = children.shape[0] + 1
    pairs = [(int(a), int(b)) for a, b in children if a < n and b < n]
    a, b = min(pairs, key=lambda p: float(((patterns[p[0]] != patterns[p[1]]) * counts).sum()))
    return f"{names[a]},{names[b]}"


def rescore_newick(torch, newick: str, names, patterns, counts, dev) -> tuple[float, float]:
    """(K1, plain) scores of a printed tree on the alignment's patterns."""
    from trex_tpu_torch.io import align_leaf_order, load_newick
    from trex_tpu_torch.ops.fitch_cuda import batched_fitch_score_cuda, batched_fitch_score_plain

    topo, _, tree_names = load_newick(newick, dev)
    topo = align_leaf_order(topo, tree_names, names)
    children = topo.children[None].contiguous()
    pat = torch.as_tensor(patterns.astype(np.int32), device=dev)
    w = torch.as_tensor(counts.astype(np.float32), device=dev)
    return (float(batched_fitch_score_cuda(children, pat, w)[0]),
            float(batched_fitch_score_plain(children, pat, w)[0]))


def clade_newick(topology, names, size: int) -> tuple[str, list[int]]:
    """The induced tree on ``size`` taxa of the smallest clade of
    ``topology`` with at least ``size`` leaves, as newick, and its taxa."""
    from trex_tpu_torch.io import prune_to_taxa, save_newick
    from trex_tpu_torch.search.bootstrap import subtree_leaf_sets

    clade = min((c for c in subtree_leaf_sets(topology) if len(c) >= size), key=len)
    keep = sorted(clade)[:size]
    pruned, _, _ = prune_to_taxa(topology, keep)
    return save_newick(pruned, [names[i] for i in keep]), keep


def relabelled_masks(masks: np.ndarray, n_states: int, seed: int) -> np.ndarray:
    """DNA masks with each site's four states sent to four of ``n_states``
    states by a random injection (bit 31 used where n_states is 32): Fitch
    scores every tree alike on both, so stepwise addition grows the same
    tree from either."""
    rng = np.random.default_rng(seed)
    length = masks.shape[1]
    targets = np.stack([rng.permutation(n_states)[:4] for _ in range(length)])  # (L, 4)
    out = np.zeros(masks.shape, np.int64)
    for b in range(4):
        out |= np.where((masks >> b) & 1, np.int64(1) << targets[:, b][None, :], 0)
    return (out - ((out >> 31) << 32)).astype(np.int32)


def slice_1b_routes(torch, dev, workdir: str, main_fasta: str, nni_fasta: str, main_run,
                    nni_run, reset_counts, launch_counts, k1_on) -> dict:
    """The support route, the enumerating routes and the batched stepwise
    path at full width, each with every launch count set to 0 just before
    it and read just after. K1 is then held bit for bit to its plain
    version (in slices of trees where the batch is large) on a candidate
    batch of each route's own shape: a bootstrap replicate's first NNI
    round under its weights, and the neighborhood of each enumerating
    route's final tree (``k1_at_this_shape``)."""
    from trex_tpu_torch.alignment import compress_alignment
    from trex_tpu_torch.cli._common import _load_alignment
    from trex_tpu_torch.io import nni_neighbors_host, spr_neighborhood_host, tbr_neighborhood_host
    from trex_tpu_torch.search.bootstrap import _replicate_weights, subtree_leaf_sets
    from trex_tpu_torch.search.hillclimb import constraint_mask
    from trex_tpu_torch.search.stepwise import stepwise_addition

    def k1_at(batch_children, pats, weights) -> dict:
        return dict(trees=int(batch_children.shape[0]), n_taxa=int(pats.shape[0]),
                    unique_patterns=int(pats.shape[1]), **k1_on(
                        torch.as_tensor(np.ascontiguousarray(batch_children), device=dev),
                        torch.as_tensor(pats.astype(np.int32), device=dev),
                        torch.as_tensor(np.asarray(weights, np.float32), device=dev),
                        plain_reps=1))

    routes = {}
    names, masks, _ = _load_alignment(main_fasta, "dna")
    patterns, counts = compress_alignment(masks)
    outgroup = cherry_outgroup(main_run.result.topology, patterns, counts, names)

    # infer --ratchet 2 --decay --bootstrap 8 --outgroup <cherry>, the
    # default spr-scan climb from a stepwise start, 512 x 2048.
    argv = ["infer", "--alignment", main_fasta, *SUPPORT_ARGS, "--outgroup", outgroup]
    reset_counts()
    run, wall = timed_cli(torch, argv)
    counts_k = launch_counts()
    if counts_k["k1"] <= 0 or counts_k["k2"] <= 0 or any(
            counts_k[k] for k in ("k34", "k5", "k6", "plan")):
        raise AssertionError(f"support route launches: {counts_k}")
    out = run.out
    rescored = rescore_newick(torch, out["tree"], names, patterns, counts, dev)
    if set(rescored) != {out["parsimony_score"]}:
        raise AssertionError(f"support route: rescored {rescored} != {out['parsimony_score']}")
    root = run.result.topology.children[-1].tolist()
    out_ids = frozenset(names.index(x) for x in outgroup.split(","))
    root_clades = [frozenset([c]) if c < len(names) else subtree_leaf_sets(
        run.result.topology)[c - len(names)] for c in root]
    if out_ids not in root_clades:
        raise AssertionError("support route: the outgroup is not a child of the root")
    decay = [d for d in out["decay"] if d is not None]
    if not decay or len(out["split_support"]) != len(names) - 1:
        raise AssertionError(f"support route: decay {len(decay)}, supports")
    routes["support"] = dict(
        command=" ".join(["infer", *SUPPORT_ARGS, "--outgroup", outgroup]) + " (512 x 2048)",
        parsimony_score=out["parsimony_score"], main_path_score=main_run.out["parsimony_score"],
        rescored=rescored, decay_non_nan=len(decay), decay_range=[min(decay), max(decay)],
        mean_split_support=out["mean_split_support"], outgroup_at_root=True,
        start_s=run.seconds["start"], ratchet_s=run.seconds["climb"],
        decay_s=run.seconds["decay"], bootstrap_s=run.seconds["bootstrap"], wall_s=wall,
        launches=counts_k)
    # The first replicate's first round: the NNI neighborhood of the
    # reference tree under the replicate's weights, drawn as infer draws
    # them (a CPU generator seeded with --seed + 1, default seed 0).
    replicate = _replicate_weights(patterns.shape[1], 8, counts,
                                   torch.Generator().manual_seed(1))[0].numpy()
    routes["support"]["k1_at_this_shape"] = dict(
        batch="bootstrap replicate 0, first NNI round", zero_weight_patterns=int(
            (replicate == 0).sum()),
        **k1_at(nni_neighbors_host(run.result.topology)[0], patterns, replicate))
    emit("support_route", **routes["support"])

    # The enumerating climbs: SPR from the balanced tree (128 x 1024), TBR
    # sampled to 16384 a round from a stepwise start (512 x 2048), NNI
    # under a 16-taxon constraint from the NNI route's tree (128 x 1024).
    nni_names, nni_masks, _ = _load_alignment(nni_fasta, "dna")
    nni_patterns, nni_counts = compress_alignment(nni_masks)
    newick, keep = clade_newick(nni_run.result.topology, nni_names, CONSTRAINT_TAXA)
    clade_path = os.path.join(workdir, "clade.nwk")
    with open(clade_path, "w") as fh:
        fh.write(newick + "\n")
    enumerating = {}
    for key, fasta, flags, aln in (
        ("spr", nni_fasta, ["--start", "balanced", "--neighborhood", "spr", "--rounds",
                            str(SPR_ROUNDS)], (nni_names, nni_patterns, nni_counts)),
        ("tbr", main_fasta, ["--neighborhood", "tbr", "--rounds", str(TBR_ROUNDS)],
         (names, patterns, counts)),
        ("nni_constraint", nni_fasta, ["--neighborhood", "nni", "--constraint", clade_path],
         (nni_names, nni_patterns, nni_counts)),
    ):
        reset_counts()
        run, wall = timed_cli(torch, ["infer", "--alignment", fasta, *flags])
        counts_k = launch_counts()
        if counts_k["k1"] <= 0 or any(counts_k[k] for k in ("k34", "k5", "k6", "plan")):
            raise AssertionError(f"{key} route launches: {counts_k}")
        out = run.out
        rescored = rescore_newick(torch, out["tree"], *aln, dev)
        if set(rescored) != {out["parsimony_score"]}:
            raise AssertionError(f"{key} route: rescored {rescored} != {out['parsimony_score']}")
        cap = int(flags[flags.index("--rounds") + 1]) if "--rounds" in flags else 100
        scored_rounds = out["search_rounds"] + (out["search_rounds"] < cap)
        enumerating[key] = dict(
            command=" ".join(["infer", *flags]), n_taxa=out["n_taxa"],
            parsimony_score=out["parsimony_score"], rescored=rescored,
            search_rounds=out["search_rounds"], evaluations=out["evaluations"],
            candidates_a_round=(out["evaluations"] - 1) / scored_rounds,
            generate_s_a_round=run.seconds["generate"] / scored_rounds,
            k1_s_a_round=run.seconds["score"] / scored_rounds,
            start_s=run.seconds["start"], climb_s=run.seconds["climb"], wall_s=wall,
            launches=counts_k)
        if key == "spr":
            batch = spr_neighborhood_host(run.result.topology)[0]
        elif key == "tbr":
            batch = tbr_neighborhood_host(run.result.topology, max_trees=TBR_BUDGET, seed=SEED)[0]
        else:
            batch = nni_neighbors_host(run.result.topology)[0]
        if key == "nni_constraint":
            ctopo, cnames = load_tree(clade_path)
            ids = [nni_names.index(x) for x in cnames]
            splits = [frozenset(ids[i] for i in c) for c in subtree_leaf_sets(ctopo)
                      if 2 <= len(c) <= len(ids) - 2]
            check = constraint_mask(splits, len(nni_names), frozenset(keep))
            held = bool(check(run.result.topology.children.cpu().numpy()[None])[0])
            if not held or out["constraint_splits"] != len(splits):
                raise AssertionError(f"constraint route: held {held}, {out['constraint_splits']}")
            enumerating[key].update(constraint_splits=out["constraint_splits"],
                                    constraint_taxa=out["constraint_taxa"], constraint_held=True)
            batch = batch[check(batch)]
        enumerating[key]["k1_at_this_shape"] = dict(
            batch="neighborhood of the final tree", **k1_at(batch, aln[1], aln[2]))
        emit("enumerating_route", route=key, **enumerating[key])
    routes["enumerating"] = enumerating

    # The batched stepwise path (K1 a step) at 32 states on the NNI route's
    # first BATCHED_STEPWISE_TAXA taxa x 1024 patterns (cut from all 128:
    # the CPU's run took 27.5 of the phase's 44 s): the masks with
    # each site's states sent to 4 of 32 (bit 31 used). The card's tree and
    # score equal the CPU's and the same path's on the DNA masks (Fitch is
    # blind to the states' names).
    nni_patterns = nni_patterns[:BATCHED_STEPWISE_TAXA]
    wide = relabelled_masks(nni_patterns, 32, SEED + 50)
    w = nni_counts.astype(np.float32)
    reset_counts()
    (card, card_s) = timed(lambda: stepwise_addition(
        wide, 32, sequences_are_masks=True, site_weights=w, seed=0, use_scan=False,
        device=dev))
    torch.cuda.synchronize()
    counts_k = launch_counts()
    if counts_k["k1"] <= 0 or any(counts_k[k] for k in ("k2", "k34", "k5", "k6", "plan")):
        raise AssertionError(f"batched stepwise launches: {counts_k}")
    (cpu, cpu_s) = timed(lambda: stepwise_addition(
        wide, 32, sequences_are_masks=True, site_weights=w, seed=0, use_scan=False,
        device="cpu"))
    dna = stepwise_addition(nni_patterns, 4, sequences_are_masks=True, site_weights=w, seed=0,
                            use_scan=False, device=dev)
    same = [(t.children.cpu().tolist(), sc) for t, sc in (card, cpu, dna)]
    if not same[0] == same[1] == same[2]:
        raise AssertionError(f"batched stepwise: card {card[1]}, cpu {cpu[1]}, dna {dna[1]}")
    routes["stepwise_batched"] = dict(
        call="stepwise_addition(use_scan=False), n_states 32", n_taxa=wide.shape[0],
        unique_patterns=wide.shape[1], parsimony_score=card[1], card_s=card_s, cpu_s=cpu_s,
        k1_launches=counts_k["k1"], k1_calls=wide.shape[0] - 2, same_as_cpu=True,
        same_as_dna_masks=True, launches=counts_k)
    emit("stepwise_batched", **routes["stepwise_batched"])
    return routes


def load_tree(path: str):
    """(topology, leaf names) of a newick file."""
    from trex_tpu_torch.io import load_newick

    with open(path) as fh:
        topo, _, names = load_newick(fh.read())
    return topo, names


def slice_1b_reference(torch, workdir: str, ref_fasta: str) -> list[dict]:
    """Each slice 1b flag on the card and on the CPU at 24 x 300 (32 x 300
    for ``--start balanced``): the same JSON (ML: the same keys, tree and
    rounds, likelihoods within rtol 1e-5)."""
    from trex_tpu_torch.cli._common import _load_alignment

    names = _load_alignment(ref_fasta, "dna")[0]
    base = run_cli(["infer", "--alignment", ref_fasta, "--orders", "1", "--device", "cpu"])
    outgroup = ",".join(names[i] for i in next(
        (int(a), int(b)) for a, b in base.result.topology.children.tolist()
        if a < len(names) and b < len(names)))
    clade = os.path.join(workdir, "ref_clade.nwk")
    with open(clade, "w") as fh:
        fh.write(f"(({names[0]},{names[1]}),({names[2]},({names[3]},({names[4]},{names[5]}))));\n")
    balanced = os.path.join(workdir, "balanced.fasta")
    simulate_fasta(balanced, BALANCED_REF["n_taxa"], BALANCED_REF["n_sites"], SEED + 8,
                   branch=(0.2, 0.6))
    cases = [
        (ref_fasta, ["--decay"]),
        (ref_fasta, ["--outgroup", outgroup]),
        (ref_fasta, ["--neighborhood", "nni", "--constraint", clade]),
        (ref_fasta, ["--neighborhood", "spr"]),
        (ref_fasta, ["--neighborhood", "tbr"]),
        (ref_fasta, ["--start", "random", "--restarts", "2"]),
        (ref_fasta, ["--ratchet", "2"]),
        (ref_fasta, ["--bootstrap", "4", "--outgroup", outgroup]),
        (balanced, ["--start", "balanced", "--neighborhood", "nni"]),
    ]
    rows = []
    for fasta, flags in cases:
        argv = ["infer", "--alignment", fasta, "--orders", "1", *flags]
        on_card = run_cli(argv).out
        on_cpu = run_cli(argv + ["--device", "cpu"]).out
        if on_card != on_cpu:
            raise AssertionError(f"{flags}: card {on_card} != cpu {on_cpu}")
        rows.append(dict(flags=" ".join(flags), n_taxa=on_card["n_taxa"],
                         parsimony_score=on_card["parsimony_score"],
                         **{k: on_card[k] for k in ("decay", "split_support",
                                                    "constraint_splits") if k in on_card},
                         same_json=True))
    argv = ["infer", "--alignment", ref_fasta, "--orders", "1", "--criterion", "ml",
            "--neighborhood", "nni", "--outgroup", names[5]]
    on_card = run_cli(argv).out
    on_cpu = run_cli(argv + ["--device", "cpu"]).out
    rel = abs(on_card["neg_log_likelihood"] - on_cpu["neg_log_likelihood"]) / abs(
        on_cpu["neg_log_likelihood"])
    if (list(on_card) != list(on_cpu) or rel > 1e-5
            or strip_lengths(on_card["tree"]) != strip_lengths(on_cpu["tree"])):
        raise AssertionError(f"ml --outgroup: card {on_card} != cpu {on_cpu}")
    rows.append(dict(flags=" ".join(argv[5:]), neg_log_likelihood=on_card["neg_log_likelihood"],
                     same_tree=True, rel_err=rel))
    return rows


# The phases ``--phases`` selects from; ``card`` and ``build`` always run.
# A phase named here runs the phases it needs first (REQUIRES).
PHASES = ("card", "build", "native", "kernels", "routes", "differentiable", "slice_1b",
          "reference", "ml_models", "score_ml", "trait", "ml", "protein", "reference_2b",
          "slice_2c", "reference_2c", "supports", "reference_supports", "bayes",
          "reference_bayes", "simulate", "dnds", "reference_models", "mesh", "reference_mesh",
          "mesh_bayes")
REQUIRES = {"routes": ("kernels",), "slice_1b": ("kernels", "routes"),
            "score_ml": ("ml_models",), "trait": ("ml_models",), "slice_2c": ("ml_models",)}
SLICE_2B_PHASES = ("ml_models", "score_ml", "trait", "ml", "protein")
# The phases whose measurements make up the kernels line's full entries.
EARLIER_PHASES = {"kernels", "routes", "differentiable", "slice_1b"}


def parse_phases(argv: list[str]) -> set[str]:
    """The phases of ``--phases a,b,...`` (default: all) with what they
    need; an unknown name exits with status 2."""
    import argparse

    parser = argparse.ArgumentParser(prog="chip_smoke.py")
    parser.add_argument("--phases", default=",".join(PHASES),
                        help="comma-separated phases to run: " + ", ".join(PHASES))
    names = [n.strip() for n in parser.parse_args(argv).phases.split(",") if n.strip()]
    unknown = sorted(set(names) - set(PHASES))
    if unknown:
        parser.error(f"unknown phase(s) {', '.join(unknown)}; choose from {', '.join(PHASES)}")
    chosen, todo = set(), list(names)
    while todo:
        name = todo.pop()
        if name not in chosen:
            chosen.add(name)
            todo.extend(REQUIRES.get(name, ()))
    return chosen


def k3_model_entry(slice_2b: dict, slice_2c: dict) -> dict | None:
    """K3/K4's kernels-line entry from slice 2b's and 2c's measurements
    alone (a run of a subset of the phases), or None when none was taken:
    K4's per-branch mode at the ML bootstrap's batch where slice 2c ran."""
    batches = slice_2b.get("at_model_routes") or {}
    if not batches and not slice_2c:
        return None
    first = slice_2c.get("at_ml_bootstrap") or batches.get("gtr_nni") or next(
        iter(batches.values()))
    launches = {**slice_2b.get("launches", {}),
                **{k: v["k34"] for k, v in slice_2c.get("launches", {}).items()}}
    return {
        "name": "likelihood_batched", "route": "cuda",
        "source": "trex_tpu_torch/csrc/likelihood_batched.cu",
        "replaces": ["trex_tpu/ops/likelihood_pallas.py:255",
                     "trex_tpu/ops/likelihood_pallas.py:135"],
        "launches": sum(launches.values()),
        "route_launches": launches,
        **{k: first[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")},
        "library_ms": None, "at_model_routes": batches,
        **slice_2c_fields(slice_2c),
    }


def per_site_entry(supports: dict) -> dict | None:
    """K4's per-site mode's kernels-line entry (the same kernel as K3/K4,
    its rows without the site-sum grid) from the supports phase: held and
    timed at the supports route's first aLRT chunk, launches of the route
    (its per-site grids) and of topotest; or None when the phase did not
    run."""
    if not supports:
        return None
    first = supports["k4_per_site"]["alrt"]
    return {
        "name": "likelihood_batched_per_site", "route": "cuda",
        "source": "trex_tpu_torch/csrc/likelihood_batched.cu",
        "replaces": "trex_tpu/ops/likelihood_pallas.py:135",
        "launches": supports["route"]["launches"]["k34_per_site"],
        "topotest_launches": supports["topotest_launches"]["k34_per_site"],
        **{k: first[k] for k in ("max_abs_err", "max_rel_err", "ms", "plain_ms", "bound_ms",
                                 "bound_by", "device_ms")},
        "library_ms": None, "at_first_chunks": supports["k4_per_site"],
    }


def slice_2c_fields(slice_2c: dict) -> dict:
    """The K3/K4 entry's fields from slice 2c: the routes' launches by
    mode, K4 at the ML bootstrap's batch, K3 at the ratchet's and the
    constrained climb's."""
    if not slice_2c:
        return {}
    return {
        "slice_2c_route_launches": {
            route: {k: v[k] for k in ("k34", "k34_shared", "k34_per_branch")}
            for route, v in slice_2c["launches"].items()},
        "at_ml_bootstrap": slice_2c["at_ml_bootstrap"],
        "at_ml_ratchet": slice_2c["at_ml_ratchet"],
        "at_ml_constraint": slice_2c["at_ml_constraint"],
    }


# Slice 2b: fitted ML models and rate heterogeneity. The model routes run
# on an alignment simulated under GTR+G (TRUE_GTR) at the main path's width,
# the protein route under a synthetic PAML matrix with +G; both write their
# truth into the phase line.
TRUE_GTR = dict(
    # Exchangeabilities in upper-triangle order AC, AG, AT, CG, CT, GT (GT
    # pinned to 1, as the fit pins its last pair), frequencies ACGT, shape.
    pair_rates=(1.2, 4.0, 0.6, 0.9, 3.3, 1.0), freqs=(0.3, 0.2, 0.22, 0.28), gamma_shape=0.5,
)
MODEL_SHAPE = dict(n_taxa=512, n_sites=2048)
PROTEIN_SHAPE = dict(n_taxa=128, n_sites=1024)
MODEL_BRANCH = (0.02, 0.15)
# The scan variant runs at ML_SCAN_SHAPE (its +G scan rounds cost about 28
# s each at 512 x 2048); the NNI variant at MODEL_SHAPE.
MODEL_ROUTES = {
    "scan": ["--model", "gtr+g", "--model-rounds", "1", "--rounds", "3"],
    "nni": ["--neighborhood", "nni", "--model", "gtr+g", "--model-rounds", "1",
            "--rounds", "10"],
}
# Adam steps of the profiled fit (the route's fits run the CLI's 800).
PROFILED_STEPS = 20
# Adam steps of the caterpillar fit's profile (511 levels a pass, each launch traced).
DEEP_FIT_STEPS = 3
# Adam steps of every fit in the card-against-CPU reference (both devices
# alike; the full-width routes run the CLI's 800): a fit is launch-bound,
# about 15 ms a step on either device at 24 taxa. Cut from 50 for the
# samplers' mesh phase.
REF_FIT_STEPS = 25
# partition --search's fits cut from the command's 600 Adam steps (about 60 s of
# its 67 s on an H100), to 300 to make room for the Bayesian phases, then to
# 200 for the mesh phases, then to 100 for the samplers' mesh phase.
PARTITION_FIT_STEPS = 100
# The model routes' (GTR+G scan and NNI, protein) and score_ml's fits cut
# from the CLI's 800 Adam steps (about 40 s of each model route's 43-52 s
# on an H100), to 300 to make room for the models and simulation phases,
# then to 200 for the mesh phases, then to 100 for the samplers' mesh
# phase.
MODEL_FIT_STEPS = 100
# modeltest's fits cut from the command's 500 Adam steps for the mesh
# phases.
MODELTEST_FIT_STEPS = 300
MODEL_REF_CASES = (
    ("gtr+g", "spr-scan"), ("gtr+g", "nni"), ("hky+i", "spr-scan"), ("hky+i", "nni"),
    ("jc+r3", "spr-scan"), ("jc+r3", "nni"), ("empirical", "spr-scan"), ("empirical", "nni"),
)


def pair_matrix(pair_rates, q: int) -> np.ndarray:
    """(Q, Q) symmetric exchangeabilities from upper-triangle pairs."""
    rates = np.zeros((q, q))
    rates[np.triu_indices(q, 1)] = pair_rates
    return rates + rates.T


def write_paml(path: str, q: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """A synthetic PAML rate file (lower-triangle exchangeabilities, then
    frequencies) drawn from ``seed``; returns what the port parses of it."""
    from trex_tpu_torch.io import parse_paml_rates

    rng = np.random.default_rng(seed)
    values = rng.uniform(0.1, 4.0, q * (q - 1) // 2)
    rows, k = [], 0
    for i in range(1, q):
        rows.append(" ".join(f"{v:.5f}" for v in values[k:k + i]))
        k += i
    freqs = rng.dirichlet(np.full(q, 4.0))
    text = "\n".join(rows) + "\n" + " ".join(f"{f:.5f}" for f in freqs) + "\n"
    with open(path, "w") as fh:
        fh.write(text)
    return parse_paml_rates(text, q)


def simulate_model_fasta(path: str, n_taxa: int, n_sites: int, seed: int, rates, freqs,
                         gamma_shape: float, letters: bytes = b"ACGT",
                         branch=MODEL_BRANCH, missing: float = 0.01) -> None:
    """An alignment down a random coalescent tree (branch lengths uniform in
    ``branch``) under the reversible model (``rates``, ``freqs``) with
    four equal-weight discrete-Gamma rate categories (``gamma_shape`` None:
    one rate), a ``missing`` share of characters replaced by '-'. Every
    draw's count is fixed by the shapes, so one seed gives one tree and one
    set of uniform draws whatever the model: with ``branch`` doubled, the
    same tree with every length doubled."""
    import torch

    from trex_tpu_torch.ops.likelihood import discrete_gamma_rates, gtr_generator

    rng = np.random.default_rng(seed)
    q = len(letters)
    freqs = np.asarray(freqs, np.float64)
    gen = gtr_generator(torch.as_tensor(rates, dtype=torch.float32),
                        torch.as_tensor(freqs, dtype=torch.float32)).double()
    cat_rates = (torch.ones(4, dtype=torch.float64) if gamma_shape is None
                 else discrete_gamma_rates(gamma_shape, 4).double())
    site_cat = rng.integers(0, 4, n_sites)
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
    seqs = {root: rng.choice(q, n_sites, p=freqs / freqs.sum())}
    stack = [root]
    while stack:
        parent = stack.pop()
        for child in kids.get(parent, ()):
            t = rng.uniform(*branch)
            cdf = torch.linalg.matrix_exp(gen * (t * cat_rates)[:, None, None]).cumsum(-1).numpy()
            rows = cdf[site_cat, seqs[parent]]  # (L, Q)
            seqs[child] = np.minimum((rng.random(n_sites)[:, None] > rows).sum(1), q - 1)
            stack.append(child)
    table = np.frombuffer(letters, dtype=np.uint8)
    with open(path, "w") as fh:
        for t in range(n_taxa):
            row = table[seqs[t]].copy()
            row[rng.random(n_sites) < missing] = ord("-")
            fh.write(f">taxon{t}\n{row.tobytes().decode()}\n")


def gtr_truth() -> dict:
    return dict(gtr_rates=pair_matrix(TRUE_GTR["pair_rates"], 4).round(5).tolist(),
                base_frequencies=list(TRUE_GTR["freqs"]), gamma_shape=TRUE_GTR["gamma_shape"])


def fit_profile(torch, topology, leaves, weights, n_states: int, model: str,
                steps: int = PROFILED_STEPS, **model_kw) -> dict:
    """``profile_phase`` of a ``steps``-step ``optimize_model`` on the card
    (its unprofiled wall taken just before): launches a step, idle share,
    top kernels."""
    from trex_tpu_torch.ops.likelihood import optimize_model

    def fit():
        optimize_model(topology, leaves, n_states, model=model, n_iterations=steps,
                       sequences_are_masks=True, site_weights=weights, **model_kw)

    fit()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fit()
    torch.cuda.synchronize()
    prof = profile_phase(torch, fit, time.perf_counter() - t0)
    return dict(prof, steps=steps, launches_per_step=prof["device_launches"] / steps,
                ms_per_step=prof["unprofiled_wall_s"] / steps * 1e3)


def k3_model_batch(torch, dev, children, leaves, weights, prior, transition, timer) -> dict:
    """K3 on one route's NNI batch under the route's model (a shared P and a
    non-uniform prior), held within rtol K34_RTOL of its plain version and
    timed, with its plan and bound."""
    from trex_tpu_torch._device import device_limits
    from trex_tpu_torch.ops.likelihood_cuda import (
        batched_log_likelihood_cuda,
        batched_log_likelihood_plain,
    )
    from trex_tpu_torch.ops.likelihood_cuda import launch_plan as k34_plan

    q = transition.shape[-1]

    def run(fn):
        return lambda: fn(children, leaves, weights, prior, transition, sequences_are_masks=True)

    plan = k34_plan(leaves.shape[0], q, True, True, device_limits(dev).smem_optin)
    shape = (children.shape[0], leaves.shape[0], leaves.shape[1], q, False)
    got = measure(torch, run(batched_log_likelihood_cuda), run(batched_log_likelihood_plain),
                  *k34_work(*shape), rtol=K34_RTOL, plain_reps=2)
    return dict(batch=shape[0], n_taxa=shape[1], patterns=shape[2], n_states=q,
                plan=dataclasses.asdict(plan), **got, **timer(run(batched_log_likelihood_cuda),
                                                              got["ms"]))


def model_route(torch, dev, fasta: str, argv_tail: list[str], reset_counts, launch_counts,
                workdir: str, name: str, alphabet: str = "dna") -> tuple:
    """One ``infer --criterion ml --model ...`` run on the card, every count
    set to 0 just before it and read just after, with its peak device
    memory; returns (InferRun, phase fields)."""
    tree_path = os.path.join(workdir, f"{name}.nwk")
    argv = ["infer", "--alignment", fasta, "--alphabet", alphabet, "--criterion", "ml",
            *argv_tail, "--output-tree", tree_path]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    run = run_cli(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    out = run.out
    if not np.isfinite(out["neg_log_likelihood"]) or out["neg_log_likelihood"] <= 0:
        raise AssertionError(f"{name}: bad result {out}")
    fields = dict(
        command=" ".join(argv[:1] + argv[3:-2]), n_taxa=out["n_taxa"], n_sites=out["n_sites"],
        unique_patterns=out["unique_patterns"], neg_log_likelihood=out["neg_log_likelihood"],
        ranking_score=out["ranking_score"], search_rounds=out["search_rounds"],
        model_rounds=out.get("model_rounds", 0), wall_s=wall,
        seconds={k: run.seconds.get(k) for k in ("start", "climb", "newton", "fit", "rounds")},
        fitted={k: out.get(k) for k in ("gtr_rates", "base_frequencies", "gamma_shape")},
        launches=counts, peak_memory_bytes=torch.cuda.max_memory_allocated(),
    )
    return run, fields, tree_path


def slice_2b_routes(torch, dev, workdir: str, phases: set, reset_counts, launch_counts,
                    timer) -> dict:
    """Slice 2b's routes: the model routes (GTR+G, the NNI variant on 512 x
    2048, the scan variant on 128 x 1024), the protein route (empirical+G at
    20 states, 128 x 1024), ``score --criterion ml`` with joint ASR and
    site rates and ``trait`` on the NNI variant's tree, and ``ml``; each
    with every count set to 0 just before it. K3 is held at the NNI routes'
    own batches under their models. Returns the K3 measurements and
    launches for the kernels line, the GTR+G alignment and the NNI
    variant's tree."""
    from trex_tpu_torch.alignment import compress_alignment
    from trex_tpu_torch.cli._common import _load_alignment
    from trex_tpu_torch.io import nni_neighbors_host
    from trex_tpu_torch.ops.likelihood import fixed_length_model

    found: dict = {"at_model_routes": {}, "launches": {}}

    def gtr_alignment(name: str, shape: dict, seed: int):
        fasta = os.path.join(workdir, name)
        simulate_model_fasta(fasta, shape["n_taxa"], shape["n_sites"], seed,
                             pair_matrix(TRUE_GTR["pair_rates"], 4), TRUE_GTR["freqs"],
                             TRUE_GTR["gamma_shape"])
        _, aln, _ = _load_alignment(fasta, "dna")
        patterns, counts = compress_alignment(aln)
        return (fasta, torch.as_tensor(patterns.astype(np.int32), device=dev),
                torch.as_tensor(counts.astype(np.float32), device=dev))

    gtr_fasta, pat_t, w_t = gtr_alignment("gtr_g.fasta", MODEL_SHAPE, SEED + 9)
    found.update(gtr_fasta=gtr_fasta, gtr_patterns=pat_t, gtr_weights=w_t)
    variants = {"nni": (gtr_fasta, pat_t, w_t)}
    if "ml_models" in phases:
        variants["scan"] = gtr_alignment("gtr_g_scan.fasta", ML_SCAN_SHAPE, SEED + 17)
    truth = gtr_truth()

    if "ml_models" in phases:
        for variant, tail in MODEL_ROUTES.items():
            fasta, v_pat, v_w = variants[variant]
            with short_fits(MODEL_FIT_STEPS):
                run, fields, tree_path = model_route(torch, dev, fasta, tail, reset_counts,
                                                     launch_counts, workdir, f"gtr_{variant}")
            fields["reduced"] = f"fits {MODEL_FIT_STEPS} Adam steps, not 800"
            k3 = fields["launches"]["k34"]
            if (k3 > 0) != (variant == "nni") or fields["launches"]["k2"] <= 0:
                raise AssertionError(f"ml_model_route {variant}: launches {fields['launches']}")
            found["launches"][f"gtr_{variant}"] = k3
            profile = fit_profile(torch, run.result.topology, v_pat, v_w, 4, "gtr+g")
            row = dict(variant=variant, truth=truth, **fields, k3_launches=k3,
                       fit_profile=profile)
            if variant == "nni":
                rates = torch.as_tensor(run.out["gtr_rates"], dtype=torch.float32, device=dev)
                freqs = torch.as_tensor(run.out["base_frequencies"], dtype=torch.float32,
                                        device=dev)
                p, prior = fixed_length_model(4, RANKING_LENGTH, rates, freqs, dev)
                batch = torch.as_tensor(nni_neighbors_host(run.result.topology)[0], device=dev)
                row["k3_at_this_shape"] = found["at_model_routes"]["gtr_nni"] = dict(
                    model="the route's fitted GTR (as printed) at t = 0.1",
                    **k3_model_batch(torch, dev, batch, pat_t, w_t, prior.contiguous(),
                                     p.contiguous(), timer))
                del batch
                found["nni_tree"] = tree_path
            emit("ml_model_route", **row)
        # The same fit on a caterpillar over the route's patterns: the
        # deepest tree (511 levels), where the pruning's traffic and launches
        # a step are largest.
        from trex_tpu_torch.topology import from_numpy, parents_from_children

        deep = caterpillar_trees(np.random.default_rng(SEED + 15), MODEL_SHAPE["n_taxa"], 1)[0]
        emit("ml_fit_deep", tree="caterpillar", n_taxa=MODEL_SHAPE["n_taxa"],
             patterns=int(pat_t.shape[1]), model="gtr+g", fit_profile=fit_profile(
                 torch, from_numpy(deep, parents_from_children(deep), dev), pat_t, w_t, 4,
                 "gtr+g", steps=DEEP_FIT_STEPS))

    if "score_ml" in phases:
        rates_file = os.path.join(workdir, "site_rates.tsv")
        argv = ["score", "--alignment", gtr_fasta, "--tree", found["nni_tree"], "--criterion",
                "ml", "--model", "gtr+g", "--asr", "joint", "--site-rates", rates_file]
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        with short_fits(MODEL_FIT_STEPS):
            out, wall = timed_cli(torch, argv)
        rates = np.loadtxt(rates_file, skiprows=1)[:, 1]
        if rates.shape != (MODEL_SHAPE["n_sites"],) or not np.isfinite(out["log_likelihood"]):
            raise AssertionError(f"score_ml: {out}, {rates.shape}")
        emit("score_ml", command=" ".join(argv[:1] + argv[3:-1]), wall_s=wall,
             reduced=f"the fit {MODEL_FIT_STEPS} Adam steps, not 800",
             log_likelihood=out["log_likelihood"],
             joint_log_probability=out["joint_log_probability"],
             mean_site_rate=out["mean_site_rate"], mean_branch_length=out["mean_branch_length"],
             mean_ancestor_posterior=out["mean_ancestor_posterior"],
             site_rate_quartiles=np.quantile(rates, [0.25, 0.5, 0.75]).tolist(),
             launches=launch_counts(), peak_memory_bytes=torch.cuda.max_memory_allocated())

    if "trait" in phases:
        traits = os.path.join(workdir, "traits.tsv")
        write_traits(traits, found["nni_tree"], SEED + 10)
        reset_counts()
        out, wall = timed_cli(torch, ["trait", "--tree", found["nni_tree"], "--traits", traits])
        if (not np.isfinite(out["log_likelihood"])
                or len(out["ancestral_nodes"]) != MODEL_SHAPE["n_taxa"] - 1):
            raise AssertionError(f"trait: {out['mk_rate']}, {out['log_likelihood']}")
        emit("trait", n_taxa=out["n_taxa"], states=out["states"], mk_rate=out["mk_rate"],
             log_likelihood=out["log_likelihood"], wall_s=wall, launches=launch_counts(),
             mean_map_posterior=float(np.mean([
                 a["posterior"][a["map_state"]] for a in out["ancestral_nodes"]])))

    if "ml" in phases:
        reset_counts()
        (out, _), wall = timed_cli(torch, ["ml"])
        counts_ml = launch_counts()
        if counts_ml["k34"] <= 0 or not np.isfinite(out["final_neg_log_likelihood"]):
            raise AssertionError(f"ml: {out}, {counts_ml}")
        found["launches"]["ml"] = counts_ml["k34"]
        emit("ml", command="ml (defaults: 16 leaves, 128 sites, 30 rounds, SPR)", **out,
             wall_s=wall, launches=counts_ml)

    if "protein" in phases:
        paml = os.path.join(workdir, "synthetic_aa.dat")
        aa_rates, aa_freqs = write_paml(paml, 20, SEED + 11)
        aa_fasta = os.path.join(workdir, "protein.fasta")
        simulate_model_fasta(aa_fasta, PROTEIN_SHAPE["n_taxa"], PROTEIN_SHAPE["n_sites"],
                             SEED + 12, aa_rates, aa_freqs, 0.8,
                             letters=b"ARNDCQEGHILKMFPSTWYV", branch=(0.05, 0.3))
        with short_fits(MODEL_FIT_STEPS):
            run, fields, _ = model_route(
                torch, dev, aa_fasta, ["--neighborhood", "nni", "--model", "empirical+g",
                                       "--model-file", paml, "--model-rounds", "1"],
                reset_counts, launch_counts, workdir, "protein", alphabet="protein")
        fields["reduced"] = f"fits {MODEL_FIT_STEPS} Adam steps, not 800"
        k3 = fields["launches"]["k34"]
        if k3 <= 0:
            raise AssertionError(f"protein route launched no K3: {fields['launches']}")
        found["launches"]["protein"] = k3
        _, aa_aln, _ = _load_alignment(aa_fasta, "protein")
        aa_pat, aa_counts = compress_alignment(aa_aln)
        aa_t = torch.as_tensor(aa_pat.astype(np.int32), device=dev)
        aa_w = torch.as_tensor(aa_counts.astype(np.float32), device=dev)
        p, prior = fixed_length_model(20, RANKING_LENGTH, torch.as_tensor(aa_rates, device=dev),
                                      torch.as_tensor(aa_freqs, device=dev), dev)
        batch = torch.as_tensor(nni_neighbors_host(run.result.topology)[0], device=dev)
        k3_row = found["at_model_routes"]["protein_nni"] = dict(
            model="the route's empirical matrix and frequencies (the file's) at t = 0.1",
            **k3_model_batch(torch, dev, batch, aa_t, aa_w, prior.contiguous(), p.contiguous(),
                             timer))
        emit("protein_route", truth=dict(gamma_shape=0.8, frequencies="the file's"), **fields,
             k3_launches=k3, k3_at_this_shape=k3_row,
             fit_profile=fit_profile(torch, run.result.topology, aa_t, aa_w, 20, "empirical+g",
                                     fixed_rates=torch.as_tensor(aa_rates, device=dev),
                                     fixed_freqs=torch.as_tensor(aa_freqs, device=dev)))
    return found


def write_traits(path: str, tree_path: str, seed: int) -> None:
    """A 3-state trait evolved down the tree of ``tree_path`` (Mk, rate 1 on
    its branch lengths) from ``seed``, as ``taxon,state`` lines."""
    from trex_tpu_torch.io import load_newick

    with open(tree_path) as fh:
        topo, lengths, names = load_newick(fh.read())
    rng = np.random.default_rng(seed)
    children = topo.children.numpy()
    n = len(names)
    state = np.zeros(2 * n - 1, np.int64)
    state[-1] = rng.integers(3)
    for a in range(n - 2, -1, -1):
        for c in children[a]:
            change = rng.random() < 2.0 / 3.0 * (1.0 - np.exp(-1.5 * lengths[c]))
            state[c] = (state[n + a] + rng.integers(1, 3)) % 3 if change else state[n + a]
    labels = np.array(["red", "green", "blue"])
    with open(path, "w") as fh:
        fh.writelines(f"{name},{labels[state[i]]}\n" for i, name in enumerate(names))


def slice_2b_reference(torch, workdir: str) -> list[dict]:
    """Slice 2b on the card against the CPU at 24 x 300 (GTR+G data): infer
    under each model of MODEL_REF_CASES on both neighbourhoods (the same
    keys, tree, rounds; NLL within rtol 1e-4); ``score --criterion ml``
    with joint ASR and site rates; marginal and joint ASR and site rates
    under one CPU fit on both devices (states equal wherever the CPU's
    maximum leads by 1e-4, or both assignments tie); ``trait``. Every fit
    runs REF_FIT_STEPS Adam steps on both devices."""
    with short_fits(REF_FIT_STEPS):
        return _slice_2b_reference(torch, workdir)


def _slice_2b_reference(torch, workdir: str) -> list[dict]:
    card, cpu = "cuda", "cpu"
    from trex_tpu_torch.cli._common import _load_alignment
    from trex_tpu_torch.io import align_leaf_order, load_newick
    from trex_tpu_torch.ops import likelihood
    from trex_tpu_torch.ops.likelihood import posterior_site_rates
    from trex_tpu_torch.ops.likelihood_asr import (
        joint_ancestral_reconstruction,
        marginal_ancestral_posteriors,
    )

    fasta = os.path.join(workdir, "ref_gtr.fasta")
    simulate_model_fasta(fasta, REF_SHAPE["n_taxa"], REF_SHAPE["n_sites"], SEED + 13,
                         pair_matrix(TRUE_GTR["pair_rates"], 4), TRUE_GTR["freqs"],
                         TRUE_GTR["gamma_shape"], branch=(0.1, 0.4))
    paml = os.path.join(workdir, "synthetic_dna.dat")
    write_paml(paml, 4, SEED + 14)
    rows = []
    for model, neighborhood in MODEL_REF_CASES:
        argv = ["infer", "--alignment", fasta, "--orders", "1", "--criterion", "ml",
                "--neighborhood", neighborhood, "--model", model, "--model-rounds", "1",
                "--output-tree", os.path.join(workdir, "ref_model.nwk")]
        if model == "empirical":
            argv += ["--model-file", paml]
        on_card = run_cli(argv + ["--device", card]).out
        on_cpu = run_cli(argv + ["--device", cpu]).out
        rel = abs(on_card["neg_log_likelihood"] - on_cpu["neg_log_likelihood"]) / abs(
            on_cpu["neg_log_likelihood"])
        same = (list(on_card) == list(on_cpu)
                and strip_lengths(on_card["tree"]) == strip_lengths(on_cpu["tree"])
                and on_card["search_rounds"] == on_cpu["search_rounds"]
                and on_card.get("model_rounds") == on_cpu.get("model_rounds"))
        if not same or rel > 1e-4:
            raise AssertionError(f"{model} {neighborhood}: card {on_card} != cpu {on_cpu}")
        rows.append(dict(model=model, neighborhood=neighborhood, n_taxa=on_card["n_taxa"],
                         neg_log_likelihood=on_card["neg_log_likelihood"],
                         model_rounds=on_card.get("model_rounds", 0),
                         search_rounds=on_card["search_rounds"], same_tree=True, rel_err=rel))
    tree = os.path.join(workdir, "ref_model.nwk")  # the last case's tree, with lengths
    outs = {}
    for device in (card, cpu):
        outs[device] = run_cli([
            "score", "--alignment", fasta, "--tree", tree, "--criterion", "ml", "--model",
            "gtr+g", "--asr", "joint", "--site-rates", os.path.join(workdir, f"r_{device}.tsv"),
            "--device", device])
    rel = {k: abs(outs[card][k] - outs[cpu][k]) / abs(outs[cpu][k])
           for k in ("log_likelihood", "joint_log_probability", "mean_site_rate")}
    if list(outs[card]) != list(outs[cpu]) or max(rel.values()) > 1e-4:
        raise AssertionError(f"score --criterion ml: card {outs[card]} != cpu {outs[cpu]}")
    rows.append(dict(command="score --criterion ml --model gtr+g --asr joint --site-rates",
                     log_likelihood=outs[card]["log_likelihood"], rel_err=rel))
    # The ASR functions under one fit (the CPU's), on both devices.
    names, masks, _ = _load_alignment(fasta, "dna")
    with open(tree) as fh:
        topo, _, tree_names = load_newick(fh.read())
    topo = align_leaf_order(topo, tree_names, names)
    params, _ = likelihood.optimize_model(topo, torch.as_tensor(masks), 4, model="gtr+g",
                               sequences_are_masks=True, n_iterations=REF_FIT_STEPS)
    got = {}
    for device in (card, cpu):
        args = (topo.to(device), params["branch_lengths"].to(device),
                torch.as_tensor(masks, device=device), 4, params["rates"].to(device),
                params["freqs"].to(device))
        post, maps = marginal_ancestral_posteriors(*args, sequences_are_masks=True)
        states, joint_lp = joint_ancestral_reconstruction(*args, sequences_are_masks=True)
        site_rates, _ = posterior_site_rates(*args[:4], params["gamma_shape"].to(device),
                                             rates=args[4], freqs=args[5],
                                             sequences_are_masks=True)
        got[device] = [x.cpu() for x in (post, maps, states, joint_lp, site_rates)]
    post_card, maps_card, states_card, lp_card, rates_card = got[card]
    post_cpu, maps_cpu, states_cpu, lp_cpu, rates_cpu = got[cpu]
    top2 = post_cpu.topk(2, dim=1).values
    clear = (top2[:, 0] - top2[:, 1]) > 1e-4
    differ = (states_card != states_cpu).any(dim=0)
    checks = {
        "posteriors": float((post_card - post_cpu).abs().max()) <= 1e-5,
        "map_states": bool((maps_card[clear] == maps_cpu[clear]).all()),
        "joint_log_prob": bool(torch.allclose(lp_card, lp_cpu, rtol=1e-5, atol=1e-4)),
        "joint_states": bool(torch.allclose(lp_card[differ], lp_cpu[differ], atol=1e-4)),
        "site_rates": bool(torch.allclose(rates_card, rates_cpu, rtol=1e-5, atol=1e-6)),
    }
    if not all(checks.values()):
        raise AssertionError(f"ML ASR card against CPU: {checks}")
    rows.append(dict(check="marginal and joint ASR, site rates under one CPU fit",
                     sites_with_clear_map=float(clear.float().mean()),
                     joint_sites_differing=int(differ.sum()), **checks))
    traits = os.path.join(workdir, "ref_traits.tsv")
    write_traits(traits, tree, SEED + 15)
    trait = {d: run_cli(["trait", "--tree", tree, "--traits", traits, "--device", d])
             for d in (card, cpu)}
    maps_equal = [a["map_state"] for a in trait[card]["ancestral_nodes"]] == [
        a["map_state"] for a in trait[cpu]["ancestral_nodes"]]
    # A float32 likelihood resolves the Mk rate at its flat optimum to a few
    # parts in a thousand (ROADMAP.md, accepted differences).
    if (abs(trait[card]["mk_rate"] - trait[cpu]["mk_rate"]) > 1e-2 * trait[cpu]["mk_rate"]
            or abs(trait[card]["log_likelihood"] - trait[cpu]["log_likelihood"]) > 1e-4
            or not maps_equal):
        raise AssertionError(f"trait: card {trait[card]} != cpu {trait[cpu]}")
    rows.append(dict(command="trait", mk_rate=trait[card]["mk_rate"],
                     log_likelihood=trait[card]["log_likelihood"], same_map_states=True))
    return rows



# Slice 2c: the rest of ML and distance infer, modeltest and partition.
ML_SUPPORT_ARGS = ["--criterion", "ml", "--start", "nj", "--neighborhood", "nni", "--rounds",
                   "10", "--bootstrap", "8"]
ML_RATCHET_ARGS = ["--criterion", "ml", "--neighborhood", "nni", "--rounds", "10",
                   "--ratchet", "3"]
DISTANCE_REPLICATES = 20
MODELTEST_MODELS = "jc,hky+g,gtr+g"
# partition --search at ML_SCAN_SHAPE: gene 1 under GTR (TRUE_GTR's
# exchangeabilities and frequencies, one rate), gene 2 under HKY+G on the
# same tree with every branch twice as long.
GENE2 = dict(kappa=4.0, freqs=(0.25, 0.3, 0.25, 0.2), gamma_shape=0.6, multiplier=2.0)
# Adam steps of the card-against-CPU reference's modeltest and partition
# fits (both devices alike).
REF_2C_STEPS = 50


def hky_rates(kappa: float) -> np.ndarray:
    """HKY exchangeabilities: ``kappa`` on the transitions A<->G and C<->T."""
    rates = np.ones((4, 4)) - np.eye(4)
    rates[0, 2] = rates[2, 0] = rates[1, 3] = rates[3, 1] = kappa
    return rates


def partition_alignment(workdir: str, n_taxa: int, n_sites: int, seed: int,
                        branch=MODEL_BRANCH) -> tuple[str, str]:
    """A two-gene FASTA of ``n_sites`` / 2 sites each, one tree: gene 1
    under GTR, gene 2 under HKY+G with every length times GENE2's
    multiplier; returns (FASTA, RAxML partition file)."""
    half = n_sites // 2
    genes = []
    for gene, (rates, freqs, shape, scale) in enumerate((
            (pair_matrix(TRUE_GTR["pair_rates"], 4), TRUE_GTR["freqs"], None, 1.0),
            (hky_rates(GENE2["kappa"]), GENE2["freqs"], GENE2["gamma_shape"],
             GENE2["multiplier"]))):
        path = os.path.join(workdir, f"gene{gene + 1}_{n_taxa}.fasta")
        simulate_model_fasta(path, n_taxa, half, seed, rates, freqs, shape,
                             branch=(branch[0] * scale, branch[1] * scale))
        with open(path) as fh:
            genes.append(fh.read().splitlines())
    fasta = os.path.join(workdir, f"partitioned_{n_taxa}.fasta")
    with open(fasta, "w") as fh:
        for line1, line2 in zip(*genes, strict=True):
            fh.write((line1 if line1.startswith(">") else line1 + line2) + "\n")
    parts = os.path.join(workdir, f"partitions_{n_taxa}.txt")
    with open(parts, "w") as fh:
        fh.write(f"DNA, gene1 = 1-{half}\nDNA, gene2 = {half + 1}-{2 * half}\n")
    return fasta, parts


def unrooted_splits(topology) -> set[frozenset[int]]:
    """The nontrivial splits of a rooted tree read as unrooted, each named
    by its side without leaf 0."""
    from trex_tpu_torch.search.bootstrap import subtree_leaf_sets

    n = topology.n_leaves
    sides = (s if 0 not in s else frozenset(range(n)) - s for s in subtree_leaf_sets(topology))
    return {s for s in sides if 2 <= len(s) <= n - 2}


def nj_first_different_join(card: np.ndarray, cpu: np.ndarray, card_joins: np.ndarray,
                             cpu_joins: np.ndarray) -> dict | None:
    """Where NJ on the card's distance matrix first joins another pair than
    on the CPU's: None if every join is the same, else the join's index,
    the rows still active, both pairs and, on each matrix, Q(i, j) =
    (r - 2) d(i, j) - R(i) - R(j) at both pairs, with the gap between them
    relative to |Q| at the matrix's own pick. Each matrix is reduced along
    the joins both runs share, as ``search.nj.neighbor_joining`` reduces it;
    ``*_joins`` are its (n - 1, 2) children rows, the joins in order."""
    step = next((a for a in range(len(cpu_joins))
                 if tuple(card_joins[a]) != tuple(cpu_joins[a])), None)
    if step is None:
        return None
    found = dict(join=step, active_rows=len(cpu_joins) + 1 - step,
                 card_pair=[int(x) for x in card_joins[step]],
                 cpu_pair=[int(x) for x in cpu_joins[step]])
    n_leaves = card.shape[0]
    for key, d0 in (("card", card), ("cpu", cpu)):
        d = np.asarray(d0, np.float64).copy()
        ids = list(range(n_leaves))
        for a in range(step):
            i, j = ids.index(int(cpu_joins[a][0])), ids.index(int(cpu_joins[a][1]))
            new_row = 0.5 * (d[i] + d[j] - d[i, j])
            keep = [k for k in range(len(ids)) if k not in (i, j)]
            nd = np.zeros((len(keep) + 1, len(keep) + 1))
            nd[:-1, :-1] = d[np.ix_(keep, keep)]
            nd[-1, :-1] = nd[:-1, -1] = new_row[keep]
            d = nd
            ids = [ids[k] for k in keep] + [n_leaves + a]
        r = d.shape[0]
        row_sums = d.sum(axis=1)

        def q_at(pair):
            i, j = ids.index(pair[0]), ids.index(pair[1])
            return float((r - 2) * d[i, j] - row_sums[i] - row_sums[j])

        q_card, q_cpu = q_at(found["card_pair"]), q_at(found["cpu_pair"])
        own = q_card if key == "card" else q_cpu
        found[key] = dict(q_at_card_pair=q_card, q_at_cpu_pair=q_cpu,
                          gap_rel=abs(q_card - q_cpu) / abs(own))
    return found


def rescore_ranking(torch, newick: str, fasta: str) -> dict:
    """The printed tree's JC69 ranking log-likelihood (every branch at
    RANKING_LENGTH) over the alignment's patterns: K3 on the card and the
    plain version on the CPU, within rtol K34_RTOL of each other."""
    from trex_tpu_torch.alignment import compress_alignment
    from trex_tpu_torch.cli._common import _load_alignment
    from trex_tpu_torch.io import align_leaf_order, load_newick
    from trex_tpu_torch.ops.likelihood import jc69_transition
    from trex_tpu_torch.ops.likelihood_cuda import batched_log_likelihood_cuda

    names, masks, _ = _load_alignment(fasta, "dna")
    patterns, counts = compress_alignment(masks)
    topo, _, tree_names = load_newick(newick)
    topo = align_leaf_order(topo, tree_names, names)
    got = {}
    for device in ("cuda", "cpu"):
        got[device] = float(batched_log_likelihood_cuda(
            topo.children[None].to(device=device, dtype=torch.int32).contiguous(),
            torch.as_tensor(patterns.astype(np.int32), device=device),
            torch.as_tensor(counts.astype(np.float32), device=device),
            torch.full((4,), 0.25, device=device),
            jc69_transition(torch.tensor(RANKING_LENGTH, device=device), 4).contiguous(),
            sequences_are_masks=True)[0])
    rel = abs(got["cuda"] - got["cpu"]) / abs(got["cpu"])
    if rel > K34_RTOL:
        raise AssertionError(f"rescored tree: card {got['cuda']} != cpu {got['cpu']}")
    return dict(card=got["cuda"], cpu=got["cpu"], rel_err=rel)


def k4_at_ml_bootstrap(torch, dev, reference, fasta: str, replicates: int, timer) -> dict:
    """K4 at the ML bootstrap's own first batch: replicate 0's first NNI
    round (the reference tree's neighbourhood, under the replicate's
    weights drawn as ``infer`` draws them, a CPU generator seeded --seed +
    1) with a P a branch and tree, held within rtol K34_RTOL of its plain
    version and timed, beside its bound (over the patterns of nonzero
    weight), the P table's build and the same batch under one shared P
    through K3."""
    from trex_tpu_torch._device import device_limits
    from trex_tpu_torch.alignment import compress_alignment
    from trex_tpu_torch.cli._common import _load_alignment
    from trex_tpu_torch.io import nni_neighbors_host
    from trex_tpu_torch.ops.likelihood import jc69_transition
    from trex_tpu_torch.ops.likelihood_cuda import (
        batched_log_likelihood_cuda,
        batched_log_likelihood_plain,
    )
    from trex_tpu_torch.ops.likelihood_cuda import launch_plan as k34_plan
    from trex_tpu_torch.search.bootstrap import _replicate_weights

    _, masks, _ = _load_alignment(fasta, "dna")
    patterns, counts = compress_alignment(masks)
    weights = _replicate_weights(patterns.shape[1], replicates, counts,
                                 torch.Generator().manual_seed(SEED + 1))[0]
    pat = torch.as_tensor(patterns.astype(np.int32), device=dev)
    w = weights.to(device=dev, dtype=torch.float32).contiguous()
    batch = torch.as_tensor(nni_neighbors_host(reference)[0], device=dev)
    n_trees, n_taxa = batch.shape[0], pat.shape[0]
    n_all = 2 * n_taxa - 1
    shared = jc69_transition(torch.tensor(RANKING_LENGTH, device=dev), 4).contiguous()
    prior = torch.full((4,), 0.25, device=dev)

    def build():
        return shared.expand(n_trees, n_all, 4, 4).contiguous()

    per_branch = build()

    def run(fn, transition):
        return lambda: fn(batch, pat, w, prior, transition, sequences_are_masks=True)

    # A pattern of weight 0 adds nothing to the sum: the bounds count the
    # weighted ones (the kernel computes every pattern).
    weighted = int((weights > 0).sum())
    shape = (n_trees, n_taxa, weighted, 4)
    got = measure(torch, run(batched_log_likelihood_cuda, per_branch),
                  run(batched_log_likelihood_plain, per_branch), *k34_work(*shape, True),
                  rtol=K34_RTOL, plain_reps=1)
    k3 = measure(torch, run(batched_log_likelihood_cuda, shared),
                 run(batched_log_likelihood_plain, shared), *k34_work(*shape, False),
                 rtol=K34_RTOL, plain_reps=1)
    return dict(
        batch="ML bootstrap replicate 0, first NNI round", trees=n_trees, n_taxa=n_taxa,
        patterns=pat.shape[1], weighted_patterns=weighted,
        zero_weight_patterns=pat.shape[1] - weighted,
        plan=dataclasses.asdict(k34_plan(n_taxa, 4, False, True, device_limits(dev).smem_optin)),
        **got, **timer(run(batched_log_likelihood_cuda, per_branch), got["ms"]),
        p_table_bytes=per_branch.numel() * 4, p_table_build_ms=time_ms(torch, build, 10),
        shared_p_k3=dict({k: k3[k] for k in ("max_rel_err", "ms", "ms_back_to_back",
                                             "bound_ms", "bound_by")},
                         **timer(run(batched_log_likelihood_cuda, shared), k3["ms"])),
    )


def ml_route(torch, argv: list[str], reset_counts, launch_counts) -> tuple:
    """One ``infer`` run on the card, every count set to 0 just before it
    and read just after, with its peak device memory: (InferRun, wall,
    launches, peak bytes)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    run, wall = timed_cli(torch, argv)
    return run, wall, launch_counts(), torch.cuda.max_memory_allocated()


def slice_2c_routes(torch, dev, workdir: str, main_fasta: str, nni_fasta: str, slice_2b: dict,
                    reset_counts, launch_counts, timer) -> dict:
    """Slice 2c's routes: the ML support route (NJ start, K3 climb, Newton,
    8 bootstrap replicates through K4's per-branch mode) and the ML ratchet
    route on the main path's 512 x 2048 alignment, the constrained ML climb
    on 128 x 1024, the distance route (NJ with 20 replicates, and UPGMA) on
    512 x 2048, ``modeltest`` on the GTR+G alignment and the NNI model
    route's tree, and ``partition --search`` on 128 x 1024; each with every
    count set to 0 just before it and read just after, and its printed tree
    rescored on the card against the CPU. K4 is held at the bootstrap's own
    first batch, K3 at the ratchet's and the constrained climb's. Returns
    what the kernels line reads."""
    from trex_tpu_torch.alignment import compress_alignment
    from trex_tpu_torch.cli import build_parser
    from trex_tpu_torch.cli._common import _load_alignment, lowest_states
    from trex_tpu_torch.cli.models import run_partition
    from trex_tpu_torch.io import nni_neighbors_host
    from trex_tpu_torch.ops.distances import jc_distance_matrix
    from trex_tpu_torch.ops.likelihood import jc69_transition
    from trex_tpu_torch.search.bootstrap import subtree_leaf_sets
    from trex_tpu_torch.search.hillclimb import constraint_mask
    from trex_tpu_torch.search.nj import neighbor_joining, nj_start_tree

    found: dict = {"launches": {}}
    names, masks, _ = _load_alignment(main_fasta, "dna")
    patterns, counts = compress_alignment(masks)
    pat_t = torch.as_tensor(patterns.astype(np.int32), device=dev)
    w_t = torch.as_tensor(counts.astype(np.float32), device=dev)
    uniform = torch.full((4,), 0.25, device=dev)
    shared_p = jc69_transition(torch.tensor(RANKING_LENGTH, device=dev), 4).contiguous()

    # The NJ start's matrix on the card against the CPU's, and their trees.
    ints = lowest_states(patterns, 4)
    mats = {d: jc_distance_matrix(torch.as_tensor(ints, device=d), 4,
                                  torch.as_tensor(counts.astype(np.float32), device=d))
            for d in ("cuda", "cpu")}
    mat_rel = float(((mats["cuda"].cpu() - mats["cpu"]).abs()
                     / mats["cpu"].abs().clamp(min=1e-30)).max())
    nj_trees = {d: neighbor_joining(m)[0] for d, m in mats.items()}
    nj_joins = {d: t.children.cpu().numpy() for d, t in nj_trees.items()}
    same_nj = bool(np.array_equal(nj_joins["cuda"], nj_joins["cpu"]))
    first_different_join = nj_first_different_join(
        mats["cuda"].cpu().numpy(), mats["cpu"].numpy(), nj_joins["cuda"], nj_joins["cpu"])
    # Joins that differ only where Q ties exactly (at 4 rows and fewer a
    # pair's Q equals its complement's) move the root, not a split.
    same_unrooted_nj = unrooted_splits(nj_trees["cuda"]) == unrooted_splits(nj_trees["cpu"])
    if mat_rel > 1e-6 or not same_unrooted_nj:
        raise AssertionError(f"NJ start: card distances differ from the CPU's by {mat_rel}; "
                             f"first different join {first_different_join}")
    matrix_ms = time_ms(torch, lambda: jc_distance_matrix(
        torch.as_tensor(ints, device=dev), 4, w_t), 10)

    # ML support route: NJ start, K3 climb, Newton, 8 ML bootstrap
    # replicates (each a per-branch K4 NNI climb of up to 3 rounds).
    run, wall, launches, peak = ml_route(
        torch, ["infer", "--alignment", main_fasta, *ML_SUPPORT_ARGS], reset_counts,
        launch_counts)
    out = run.out
    if (launches["k34_per_branch"] <= 0 or launches["k34_shared"] <= 0
            or launches["k1"] or launches["k2"]
            or len(out["split_support"]) != len(names) - 1):
        raise AssertionError(f"ml support route: launches {launches}, {list(out)}")
    rescored = rescore_ranking(torch, out["tree"], main_fasta)
    if abs(-rescored["card"] - out["ranking_score"]) > K34_RTOL * abs(out["ranking_score"]):
        raise AssertionError(f"ml support route: rescored {rescored}, {out['ranking_score']}")
    k4 = k4_at_ml_bootstrap(torch, dev, run.result.topology, main_fasta, 8, timer)
    found["at_ml_bootstrap"] = k4
    found["launches"]["ml_support"] = launches
    found["ml_support_out"] = (run, wall)
    emit("ml_support_route", command="infer " + " ".join(ML_SUPPORT_ARGS) + " (512 x 2048)",
         n_taxa=out["n_taxa"], unique_patterns=out["unique_patterns"],
         neg_log_likelihood=out["neg_log_likelihood"], ranking_score=out["ranking_score"],
         search_rounds=out["search_rounds"], mean_split_support=out["mean_split_support"],
         nj_distances=dict(max_rel_err_card_cpu=mat_rel, same_nj_tree=same_nj,
                           same_unrooted_nj_tree=same_unrooted_nj,
                           first_different_join=first_different_join, card_ms=matrix_ms),
         seconds={k: run.seconds.get(k) for k in ("start", "climb", "newton", "bootstrap")},
         wall_s=wall, launches=launches, peak_memory_bytes=peak, rescored=rescored,
         k4_at_this_shape=k4)

    # ML ratchet route: stepwise start, then 3 kicked reclimbs (numpy draws).
    run, wall, launches, peak = ml_route(
        torch, ["infer", "--alignment", main_fasta, *ML_RATCHET_ARGS], reset_counts,
        launch_counts)
    out = run.out
    if launches["k34_shared"] <= 0 or launches["k34_per_branch"] or launches["k2"] <= 0:
        raise AssertionError(f"ml ratchet route: launches {launches}")
    rescored = rescore_ranking(torch, out["tree"], main_fasta)
    if abs(-rescored["card"] - out["ranking_score"]) > K34_RTOL * abs(out["ranking_score"]):
        raise AssertionError(f"ml ratchet route: rescored {rescored}, {out['ranking_score']}")
    batch = torch.as_tensor(nni_neighbors_host(run.result.topology)[0], device=dev)
    k3 = k3_model_batch(torch, dev, batch, pat_t, w_t, uniform, shared_p, timer)
    found["launches"]["ml_ratchet"] = launches
    found["at_ml_ratchet"] = k3
    emit("ml_ratchet_route", command="infer " + " ".join(ML_RATCHET_ARGS) + " (512 x 2048)",
         ml_iterations=out["ml_iterations"], search_rounds=out["search_rounds"],
         trace=run.result.trace, evaluations=out["evaluations"],
         neg_log_likelihood=out["neg_log_likelihood"], ranking_score=out["ranking_score"],
         seconds={k: run.seconds.get(k) for k in ("start", "climb", "newton")},
         reclimb_s=run.seconds["reclimbs"], wall_s=wall, k3_launches=launches["k34"],
         launches=launches, peak_memory_bytes=peak, rescored=rescored,
         k3_at_this_shape=dict(candidates="NNI neighbourhood of the final tree", **k3))

    # The constrained ML climb on 128 x 1024: a 16-taxon clade of the NJ tree.
    nni_names, nni_masks, _ = _load_alignment(nni_fasta, "dna")
    nni_patterns, nni_counts = compress_alignment(nni_masks)
    nj_topo, _ = nj_start_tree(lowest_states(nni_patterns, 4), 4, nni_counts, device="cpu")
    newick, keep = clade_newick(nj_topo, nni_names, CONSTRAINT_TAXA)
    clade_path = os.path.join(workdir, "ml_clade.nwk")
    with open(clade_path, "w") as fh:
        fh.write(newick + "\n")
    flags = ["--criterion", "ml", "--neighborhood", "nni", "--constraint", clade_path]
    run, wall, launches, peak = ml_route(torch, ["infer", "--alignment", nni_fasta, *flags],
                                         reset_counts, launch_counts)
    out = run.out
    ctopo, cnames = load_tree(clade_path)
    ids = [nni_names.index(x) for x in cnames]
    splits = [frozenset(ids[i] for i in c) for c in subtree_leaf_sets(ctopo)
              if 2 <= len(c) <= len(ids) - 2]
    check = constraint_mask(splits, len(nni_names), frozenset(keep))
    if not bool(check(run.result.topology.children.cpu().numpy()[None])[0]) \
            or launches["k34_shared"] <= 0:
        raise AssertionError(f"ml constrained route: clade lost or launches {launches}")
    batch = nni_neighbors_host(run.result.topology)[0]
    batch = torch.as_tensor(batch[check(batch)], device=dev)
    k3 = k3_model_batch(torch, dev, batch, torch.as_tensor(nni_patterns.astype(np.int32),
                                                           device=dev),
                        torch.as_tensor(nni_counts.astype(np.float32), device=dev), uniform,
                        shared_p, timer)
    found["launches"]["ml_constraint"] = launches
    found["at_ml_constraint"] = k3
    emit("ml_constrained_route", command="infer " + " ".join(flags[:-1]) + " <16-taxon clade>"
         " (128 x 1024)", constraint_splits=out["constraint_splits"], clade_held=True,
         search_rounds=out["search_rounds"], neg_log_likelihood=out["neg_log_likelihood"],
         seconds={k: run.seconds.get(k) for k in ("start", "climb", "newton")}, wall_s=wall,
         launches=launches, peak_memory_bytes=peak,
         rescored=rescore_ranking(torch, out["tree"], nni_fasta),
         k3_at_this_shape=dict(candidates="the final tree's NNI neighbourhood, filtered",
                               **k3))

    # The distance route: NJ with 20 replicates (their matrices in one
    # batched call), and UPGMA, 512 x 2048.
    for flags in (["--criterion", "distance", "--bootstrap", str(DISTANCE_REPLICATES)],
                  ["--criterion", "distance", "--start", "upgma"]):
        run, wall, launches, peak = ml_route(
            torch, ["infer", "--alignment", main_fasta, *flags], reset_counts, launch_counts)
        out = run.out
        if out.get("bootstrap_replicates", DISTANCE_REPLICATES) != DISTANCE_REPLICATES:
            raise AssertionError(f"distance route: {list(out)}")
        emit("distance_route", command="infer " + " ".join(flags) + " (512 x 2048)",
             method=out["method"], tree_length=out["tree_length"],
             mean_split_support=(float(np.mean(out["split_support"]))
                                 if "split_support" in out else None),
             seconds=run.seconds, wall_s=wall, launches=launches, peak_memory_bytes=peak,
             rescored=rescore_ranking(torch, out["tree"], main_fasta))

    # modeltest on the GTR+G alignment and the NNI model route's tree.
    from trex_tpu_torch.cli.models import run_modeltest

    args = build_parser().parse_args([
        "modeltest", "--alignment", slice_2b["gtr_fasta"], "--tree", slice_2b["nni_tree"],
        "--models", MODELTEST_MODELS, "--iterations", str(MODELTEST_FIT_STEPS)])
    fits: dict = {}
    reset_counts()
    clock = time.perf_counter()
    out = run_modeltest(args, fits)
    torch.cuda.synchronize()
    wall = time.perf_counter() - clock
    if out["best"] != "gtr+g" or out["criterion"] != "bic":
        raise AssertionError(f"modeltest picked {out['best']}: {out['table']}")
    topo, tree_names = load_tree(slice_2b["nni_tree"])
    from trex_tpu_torch.io import align_leaf_order

    gtr_names = _load_alignment(slice_2b["gtr_fasta"], "dna")[0]
    topo = align_leaf_order(topo, tree_names, gtr_names).to(dev)
    emit("modeltest_route", command=f"modeltest --tree <NNI model route's tree> --models "
         f"{MODELTEST_MODELS} (512 x 2048, {MODELTEST_FIT_STEPS} Adam steps a fit)",
         truth="gtr+g",
         best=out["best"], table=out["table"], fit_s=fits,
         wall_s=wall, launches=launch_counts(),
         hky_g_fit_profile=fit_profile(torch, topo, slice_2b["gtr_patterns"],
                                       slice_2b["gtr_weights"], 4, "hky+g"))

    # partition --search on 128 x 1024: two genes, the second on twice the
    # lengths.
    fasta, parts = partition_alignment(workdir, ML_SCAN_SHAPE["n_taxa"],
                                       ML_SCAN_SHAPE["n_sites"], SEED + 18)
    tree_path = os.path.join(workdir, "partition.nwk")
    args = build_parser().parse_args([
        "partition", "--alignment", fasta, "--partitions", parts, "--models", "gtr,hky+g",
        "--search", "--iterations", str(PARTITION_FIT_STEPS), "--output-tree", tree_path])
    timings: dict = {}
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    clock = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        out = run_partition(args, timings)
    torch.cuda.synchronize()
    wall = time.perf_counter() - clock
    launches = launch_counts()
    gene2 = out["partitions"][1]
    if not np.isfinite(out["log_likelihood"]) or gene2["rate_multiplier"] <= 1.0:
        raise AssertionError(f"partition: {out}")
    with open(tree_path) as fh:
        rescored = rescore_ranking(torch, fh.read(), fasta)
    emit("partition_route", command="partition --search --models gtr,hky+g (128 x 1024, "
         f"two genes of 512 sites, {PARTITION_FIT_STEPS} Adam steps a fit)",
         log_likelihood=out["log_likelihood"],
         search_rounds=out["search_rounds"], gene2_rate_multiplier=gene2["rate_multiplier"],
         gene2_truth=GENE2["multiplier"], gene2_gamma_shape=gene2.get("gamma_shape"),
         gene2_gamma_truth=GENE2["gamma_shape"], tree_length=out["tree_length"],
         seconds=dict(start=timings["start"], fits=timings["fits"], search=timings["search"]),
         scan_round_s=timings["scan_rounds"], wall_s=wall, launches=launches,
         peak_memory_bytes=torch.cuda.max_memory_allocated(), rescored=rescored)
    return found


def same_supported_json(card: dict, cpu: dict) -> bool:
    """Card and CPU ``infer`` JSON alike: the keys in order, the topology,
    every value but the lengths and likelihoods equal; likelihoods within
    rtol 1e-5; lengths within 1e-5 for distance trees (fixed by the
    matrix), 1e-3 for ML fits (the CPU tests' rule against JAX)."""
    if list(card) != list(cpu) or strip_lengths(card["tree"]) != strip_lengths(cpu["tree"]):
        return False
    atol = 1e-3 if cpu["criterion"] == "ml" else 1e-5
    lengths = [np.array(re.findall(r":([0-9.eE+-]+)", x["tree"]), float) for x in (card, cpu)]
    if not np.allclose(lengths[0], lengths[1], rtol=0, atol=atol):
        return False
    for key, value in cpu.items():
        if key in ("neg_log_likelihood", "ranking_score"):
            if abs(card[key] - value) > 1e-5 * abs(value):
                return False
        elif key in ("tree_length", "mean_branch_length"):
            if abs(card[key] - value) > atol:
                return False
        elif key != "tree" and card[key] != value:
            return False
    return True


def slice_2c_reference(torch, workdir: str) -> list[dict]:
    """Slice 2c on the card against the CPU at 24 x 300: every new
    ``infer`` flag (the same keys, trees, rounds and supports under the same
    draws; ``same_supported_json``), ``modeltest`` and
    ``partition --search`` (REF_2C_STEPS Adam steps a fit on both devices:
    the same ranking, rounds and tree; log-likelihoods within rtol 1e-4,
    slice 2b's rule)."""
    from trex_tpu_torch.cli._common import _load_alignment

    fasta = os.path.join(workdir, "ref_2c.fasta")
    simulate_fasta(fasta, REF_SHAPE["n_taxa"], REF_SHAPE["n_sites"], SEED + 16,
                   branch=(0.2, 0.6))
    names = _load_alignment(fasta, "dna")[0]
    clade = os.path.join(workdir, "ref_2c_clade.nwk")
    with open(clade, "w") as fh:
        fh.write(f"(({names[0]},{names[1]}),({names[2]},({names[3]},{names[4]})));\n")
    rows = []
    for flags in (
        ["--criterion", "distance", "--bootstrap", "5", "--outgroup", names[3]],
        ["--criterion", "distance", "--start", "upgma"],
        ["--start", "nj"],
        ["--criterion", "ml", "--start", "nj", "--neighborhood", "nni", "--bootstrap", "3"],
        ["--criterion", "ml", "--neighborhood", "nni", "--ratchet", "2"],
        ["--criterion", "ml", "--start", "random", "--ratchet", "2"],
        ["--criterion", "ml", "--neighborhood", "nni", "--constraint", clade],
    ):
        argv = ["infer", "--alignment", fasta, "--orders", "1", *flags]
        on_card = run_cli(argv).out
        on_cpu = run_cli(argv + ["--device", "cpu"]).out
        if not same_supported_json(on_card, on_cpu):
            raise AssertionError(f"{flags}: card {on_card} != cpu {on_cpu}")
        shown = {k: on_card[k] for k in ("parsimony_score", "neg_log_likelihood", "tree_length",
                                         "search_rounds", "ml_iterations", "split_support")
                 if k in on_card}
        rows.append(dict(flags=" ".join(flags).replace(clade, "<clade>"), **shown,
                         same_json=True))
    gtr = os.path.join(workdir, "ref_2c_gtr.fasta")
    simulate_model_fasta(gtr, REF_SHAPE["n_taxa"], REF_SHAPE["n_sites"], SEED + 19,
                         pair_matrix(TRUE_GTR["pair_rates"], 4), TRUE_GTR["freqs"],
                         TRUE_GTR["gamma_shape"], branch=(0.1, 0.4))
    argv = ["modeltest", "--alignment", gtr, "--models", MODELTEST_MODELS, "--iterations",
            str(REF_2C_STEPS)]
    tables = {d: run_cli(argv + ["--device", d]) for d in ("cuda", "cpu")}
    rel = max(abs(a["log_likelihood"] - b["log_likelihood"]) / abs(b["log_likelihood"])
              for a, b in zip(tables["cuda"]["table"], tables["cpu"]["table"], strict=True))
    if ([r["model"] for r in tables["cuda"]["table"]]
            != [r["model"] for r in tables["cpu"]["table"]] or rel > 1e-4):
        raise AssertionError(f"modeltest: card {tables['cuda']} != cpu {tables['cpu']}")
    rows.append(dict(command="modeltest", best=tables["cuda"]["best"], rel_err=rel))
    fasta, parts = partition_alignment(workdir, REF_SHAPE["n_taxa"], REF_SHAPE["n_sites"],
                                       SEED + 20, branch=(0.1, 0.4))
    outs = {}
    for device in ("cuda", "cpu"):
        tree = os.path.join(workdir, f"ref_partition_{device}.nwk")
        outs[device] = run_cli([
            "partition", "--alignment", fasta, "--partitions", parts, "--models", "gtr,hky+g",
            "--search", "--iterations", str(REF_2C_STEPS), "--output-tree", tree,
            "--device", device])
        with open(tree) as fh:
            outs[device]["tree"] = strip_lengths(fh.read())
    rel = abs(outs["cuda"]["log_likelihood"] - outs["cpu"]["log_likelihood"]) / abs(
        outs["cpu"]["log_likelihood"])
    if (outs["cuda"]["tree"] != outs["cpu"]["tree"] or rel > 1e-4
            or outs["cuda"]["search_rounds"] != outs["cpu"]["search_rounds"]):
        raise AssertionError(f"partition: card {outs['cuda']} != cpu {outs['cpu']}")
    rows.append(dict(command="partition --search", search_rounds=outs["cuda"]["search_rounds"],
                     log_likelihood=outs["cuda"]["log_likelihood"], rel_err=rel, same_tree=True))
    return rows


# Slice 4a: likelihood supports and tree tools. The full-width route runs
# ``infer --criterion ml --alrt 1000 --ufboot 1000`` on the main path's
# alignment (the ML NNI route's flags), then ``topotest`` on 8 of its
# trees, ``bootstrap`` at 128 x 1024 and the tree tools on the outputs.
SUPPORT_ARGS_4A = ["--criterion", "ml", "--neighborhood", "nni", "--rounds", "10",
                   "--alrt", "1000", "--ufboot", "1000"]
TOPOTEST_REPLICATES = 10_000
BOOTSTRAP_ARGS_4A = ["bootstrap", "--leaves", "128", "--sites", "1024", "--replicates", "50"]
K3_TBR_TREES = 2048  # K3's plain version at the TBR batch: its first 2048 trees
NEWTON_WINDOW_SWEEPS = 2


def k4_per_site_at(torch, dev, children, leaves, weights, lengths, timer) -> dict:
    """K4's per-site mode (rows and weighted sums, one (C, 1 + P) tensor)
    held within rtol K34_RTOL of its plain version on a chunk of candidates
    at their fitted lengths (JC, a P a branch and tree), timed, beside its
    bound (the rows are its output)."""
    from trex_tpu_torch.ops.likelihood import jc69_transition
    from trex_tpu_torch.ops.likelihood_cuda import (
        batched_log_likelihood_cuda,
        batched_log_likelihood_plain,
    )

    pmats = jc69_transition(lengths, 4).contiguous()
    prior = torch.full((4,), 0.25, device=dev)

    def run(fn):
        def call():
            sums, rows = fn(children, leaves, weights, prior, pmats, sequences_are_masks=True,
                            per_site=True)
            return torch.cat([sums[:, None], rows], dim=1)
        return call

    batch, n_taxa, n_sites = children.shape[0], leaves.shape[0], leaves.shape[1]
    n_bytes, n_ops = k34_work(batch, n_taxa, n_sites, 4, True)
    got = measure(torch, run(batched_log_likelihood_cuda), run(batched_log_likelihood_plain),
                  n_bytes + 4.0 * batch * (n_sites - 1), n_ops, rtol=K34_RTOL, plain_reps=1)
    return dict(trees=batch, n_taxa=n_taxa, patterns=n_sites, **got,
                **timer(run(batched_log_likelihood_cuda), got["ms"]))


def supports_routes(torch, dev, workdir: str, main_fasta: str, reset_counts, launch_counts,
                    timer) -> dict:
    """Slice 4a on the card: K3 at the first batch of the ML TBR climb on
    512 x 2048; the supports route (``infer --criterion ml --alrt 1000
    --ufboot 1000``, every count set to 0 just before it and read just
    after) with its walls by part, candidates, chunk, peak memory; K4's
    per-site mode held at the route's first aLRT and UFBoot chunks; a
    profiled window of NEWTON_WINDOW_SWEEPS batched Newton sweeps
    (launches a sweep, idle share); ``topotest`` on 8 of the route's
    trees; ``bootstrap`` at 128 x 1024 and ``consensus``, ``treedist``,
    ``treeprune``, ``concord``, ``treedraw`` and ``stats`` on the outputs.
    Returns what the kernels line reads."""
    from trex_tpu_torch.alignment import compress_alignment
    from trex_tpu_torch.cli._common import _load_alignment, _start_tree, lowest_states
    from trex_tpu_torch.io import (
        nni_neighbors_host,
        save_newick,
        tbr_neighborhood_host,
    )
    from trex_tpu_torch.ops.likelihood import jc69_transition
    from trex_tpu_torch.ops.likelihood_asr import newton_lengths_batched
    from trex_tpu_torch.ops.likelihood_cuda import (
        batched_log_likelihood_cuda,
        batched_log_likelihood_plain,
    )
    from trex_tpu_torch.search import alrt, ufboot
    from trex_tpu_torch.search.nj import nj_start_tree
    from trex_tpu_torch.topology import from_numpy

    found: dict = {}
    names, masks, _ = _load_alignment(main_fasta, "dna")
    patterns, counts = compress_alignment(masks)
    pat_t = torch.as_tensor(patterns.astype(np.int32), device=dev)
    w_t = torch.as_tensor(counts.astype(np.float32), device=dev)
    uniform = torch.full((4,), 0.25, device=dev)

    # K3 at the first batch of ``infer --criterion ml --neighborhood tbr``:
    # the stepwise start's TBR neighbourhood, sampled as the climber's first
    # round samples it.
    start = _start_tree("stepwise", patterns.astype(np.int32), 4, SEED, w_t, 4, dev)
    first_seed = int(np.random.default_rng(0).integers(0, 2**63 - 1))
    tbr = tbr_neighborhood_host(start, max_trees=16384, seed=first_seed)[0].copy()
    batch = torch.as_tensor(tbr, device=dev)
    shared_p = jc69_transition(torch.tensor(RANKING_LENGTH, device=dev), 4).contiguous()
    part = batch[:K3_TBR_TREES].contiguous()

    def k3_call(fn, trees):
        return lambda: fn(trees, pat_t, w_t, uniform, shared_p, sequences_are_masks=True)

    k3 = measure(torch, k3_call(batched_log_likelihood_cuda, part),
                 k3_call(batched_log_likelihood_plain, part),
                 *k34_work(part.shape[0], len(names), pat_t.shape[1], 4, False),
                 rtol=K34_RTOL, plain_reps=1)
    full_ms = time_ms(torch, k3_call(batched_log_likelihood_cuda, batch), 5)
    found["k3_at_ml_tbr"] = dict(
        batch="first round of infer --criterion ml --neighborhood tbr (512 x 2048)",
        trees_in_round=int(batch.shape[0]), trees_held=int(part.shape[0]), **k3,
        **timer(k3_call(batched_log_likelihood_cuda, part), k3["ms"]),
        full_round_ms=full_ms,
        full_round_bound_ms=bound_ms(*k34_work(batch.shape[0], len(names), pat_t.shape[1], 4,
                                               False))[0])
    emit("k3_at_ml_tbr", **found["k3_at_ml_tbr"])
    del batch, part

    # The supports route.
    argv = ["infer", "--alignment", main_fasta, *SUPPORT_ARGS_4A]
    run, wall, launches, peak = ml_route(torch, argv, reset_counts, launch_counts)
    out, seconds = run.out, run.seconds
    found["route_out"] = (run, wall)
    n_anc = len(names) - 1
    if (launches["k34_per_site"] <= 0 or launches["k34_per_branch"] <= launches["k34_per_site"]
            or len(out["sh_alrt_support"]) != n_anc or len(out["ufboot_support"]) != n_anc
            or not all(0.0 <= x <= 1.0 for x in out["ufboot_support"] + out["rell_support"])):
        raise AssertionError(f"supports route: launches {launches}, {list(out)}")
    rescored = rescore_ranking(torch, out["tree"], main_fasta)
    tree = run.result.topology
    alrt_parts, ub_parts = seconds["alrt_parts"], seconds["ufboot_parts"]
    parts = dict(
        start=seconds["start"], climb=seconds["climb"], newton=seconds["newton"],
        alrt_fit=alrt_parts["fit"], ufboot_fit=ub_parts["fit"],
        rell=alrt_parts["rell"] + ub_parts["rell"],
        host_bookkeeping=alrt_parts["enumerate"] + ub_parts["candidates"] + ub_parts["splits"],
        alrt=seconds["alrt"], ufboot=seconds["ufboot"])

    # K4's per-site mode at the first aLRT and the first UFBoot chunk, each
    # at its Newton-fitted lengths.
    children, _, by_edge = alrt._nni_alternatives_by_edge(tree)
    used = sorted({m for rows in by_edge for m in rows})
    ref_children = tree.children.cpu().numpy()
    alrt_batch = np.concatenate([ref_children[None], children[used]])
    ub_batch = ufboot.default_candidates(tree, extra_tbr=64, seed=SEED + 11).children.numpy()
    per_site_checks = {}
    for name, cands, chunk in (("alrt", alrt_batch, alrt_parts["per_site"]["chunk"]),
                               ("ufboot", ub_batch, ub_parts["per_site"]["chunk"])):
        first = torch.as_tensor(cands[:chunk], device=dev)
        lengths = newton_lengths_batched(first, pat_t, 4, weights=w_t, sequences_are_masks=True)
        per_site_checks[name] = dict(candidates=int(cands.shape[0]), chunk=int(chunk),
                                     **k4_per_site_at(torch, dev, first, pat_t, w_t, lengths,
                                                      timer))
        del first, lengths
    found["k4_per_site"] = per_site_checks

    # A profiled window of NEWTON_WINDOW_SWEEPS batched sweeps on the first
    # aLRT chunk (the first call of a fit scores its start too).
    window_children = torch.as_tensor(alrt_batch[:alrt_parts["per_site"]["chunk"]], device=dev)

    def sweeps():
        newton_lengths_batched(window_children, pat_t, 4, weights=w_t, sequences_are_masks=True,
                               n_sweeps=NEWTON_WINDOW_SWEEPS)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sweeps()
    torch.cuda.synchronize()
    window = profile_phase(torch, sweeps, time.perf_counter() - t0)
    window.update(sweeps=NEWTON_WINDOW_SWEEPS, trees=int(window_children.shape[0]),
                  launches_per_sweep=window["device_launches"] / NEWTON_WINDOW_SWEEPS)
    del window_children
    found["route"] = dict(wall_s=wall, launches=launches, parts=parts,
                          newton_window=window)
    emit("supports_route", command="infer " + " ".join(SUPPORT_ARGS_4A) + " (512 x 2048)",
         n_taxa=out["n_taxa"], unique_patterns=out["unique_patterns"],
         neg_log_likelihood=out["neg_log_likelihood"], ranking_score=out["ranking_score"],
         search_rounds=out["search_rounds"],
         mean_sh_alrt=float(np.mean(out["sh_alrt_support"])),
         mean_rell=float(np.mean(out["rell_support"])),
         mean_ufboot=float(np.mean(out["ufboot_support"])),
         alrt_candidates=int(alrt_batch.shape[0]), ufboot_candidates=out["ufboot_candidates"],
         ufboot_reference_wins=out["ufboot_reference_wins"],
         chunks={"alrt": alrt_parts["per_site"], "ufboot": ub_parts["per_site"]},
         seconds=parts, alrt_parts=alrt_parts, ufboot_parts=ub_parts, wall_s=wall,
         launches=launches, peak_memory_bytes=peak, rescored=rescored,
         newton_window=window, k4_per_site=per_site_checks)

    # topotest on 8 trees: the supports route's ML tree, the parsimony main
    # path's tree, the NJ tree and 5 NNI neighbours of the ML tree (distinct
    # unrooted trees), 10,000 replicates and the AU test's 10 scales.
    parsimony = run_cli(["infer", "--alignment", main_fasta]).out["tree"]
    nj_topo, nj_lengths = nj_start_tree(lowest_states(patterns, 4), 4, counts, device="cpu")
    seen = {frozenset(ufboot._unrooted_split_masks(tree.children.cpu().numpy()))}
    neighbours = []
    # Copies: the native library reuses its output buffers.
    nni_children, nni_parents = (x.copy() for x in nni_neighbors_host(tree))
    for c, p in zip(nni_children, nni_parents):
        sig = frozenset(ufboot._unrooted_split_masks(c))
        if sig not in seen and len(neighbours) < 5:
            seen.add(sig)
            neighbours.append(save_newick(from_numpy(c, p), names))
    trees_path = os.path.join(workdir, "topotest.nwk")
    nj_path = os.path.join(workdir, "nj.nwk")
    ml_path = os.path.join(workdir, "ml_supports.nwk")
    with open(nj_path, "w") as fh:
        fh.write(save_newick(nj_topo, names, np.clip(nj_lengths, 0.0, None)) + "\n")
    with open(ml_path, "w") as fh:
        fh.write(out["tree"] + "\n")
    with open(trees_path, "w") as fh:
        fh.write("\n".join([strip_supports(out["tree"]), parsimony,
                            save_newick(nj_topo, names), *neighbours]) + "\n")
    timings: dict = {}
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    topo_out, res = run_topotest_timed(trees_path, main_fasta, timings)
    torch.cuda.synchronize()
    topo_wall = time.perf_counter() - t0
    topo_launches = launch_counts()
    values = [row[k] for row in topo_out["table"] for k in ("p_kh", "p_sh", "p_au", "bp")]
    if (topo_out["n_trees"] != 8 or res.p_au is None or topo_launches["k34_per_site"] <= 0
            or not np.isfinite(res.log_likelihoods).all()
            or not all(0.0 <= v <= 1.0 for v in values)):
        raise AssertionError(f"topotest: {topo_out}, launches {topo_launches}")
    found["topotest_launches"] = topo_launches
    emit("topotest_route", command=f"topotest --replicates {TOPOTEST_REPLICATES} (8 trees, "
         "512 x 2048)", best=topo_out["best"], table=topo_out["table"], seconds=timings,
         wall_s=topo_wall, launches=topo_launches)

    # bootstrap at 128 x 1024, then the tree tools on the outputs.
    reset_counts()
    (boot_out, best), boot_wall = timed_cli(torch, BOOTSTRAP_ARGS_4A)
    boot_launches = launch_counts()
    if boot_launches["k1"] <= 0 or len(best) != 50:
        raise AssertionError(f"bootstrap: launches {boot_launches}")
    reps_path = os.path.join(workdir, "bootstrap_reps.nwk")
    with open(reps_path, "w") as fh:
        fh.write("".join(save_newick(t) + "\n" for t in best))
    balanced_path = os.path.join(workdir, "balanced.nwk")
    from trex_tpu_torch.topology import balanced_topology

    with open(balanced_path, "w") as fh:
        fh.write(save_newick(balanced_topology(int(BOOTSTRAP_ARGS_4A[2]), "cpu")) + "\n")
    tools = {}
    for name, argv in (
        ("consensus", ["consensus", reps_path]),
        ("treedist", ["treedist", ml_path, nj_path]),
        ("treeprune", ["treeprune", "--tree", ml_path, "--taxa", ",".join(names[:100]),
                       "--output-tree", os.path.join(workdir, "pruned.nwk")]),
        ("concord_gcf", ["concord", "--tree", balanced_path, "--gene-trees", reps_path]),
        ("concord_scf", ["concord", "--tree", ml_path, "--fasta", main_fasta, "--quartets",
                         "100"]),
        ("treedraw", ["treedraw", "--tree", ml_path]),
        ("stats", ["stats", "--alignment", main_fasta]),
    ):
        result, tool_wall = timed_cli(torch, argv)
        if name == "treedraw":
            result = {"lines": result.count("\n") + 1}
        elif name.startswith("concord"):
            values = [b["gcf" if name.endswith("gcf") else "scf"] for b in result["branches"]]
            result = {"branches": len(values), "defined": sum(v is not None for v in values),
                      "mean": float(np.mean([v for v in values if v is not None]))}
        elif name == "consensus":
            result = {k: result[k] for k in ("n_trees", "n_splits")}
        elif name == "treeprune":
            result = {k: result[k] for k in ("kept", "dropped")}
        tools[name] = dict(result, wall_s=tool_wall)
    emit("tree_tools_route", command=" ".join(BOOTSTRAP_ARGS_4A) + " (128 x 1024), then the "
         "tree tools", mean_support=boot_out["mean_support"], bootstrap_wall_s=boot_wall,
         bootstrap_launches=boot_launches, tools=tools)
    found["bootstrap_launches"] = boot_launches
    return found


def strip_supports(newick: str) -> str:
    """A newick without its internal-node labels and lengths."""
    return re.sub(r"\)[^,();]+", ")", strip_lengths(newick))


def run_topotest_timed(trees_path: str, fasta: str, timings: dict):
    """``topotest --replicates TOPOTEST_REPLICATES`` on the card, with its
    parts in ``timings``: (JSON, TopologyTestResult)."""
    from trex_tpu_torch.cli import build_parser
    from trex_tpu_torch.cli.trees import run_topotest

    args = build_parser().parse_args(["topotest", "--alignment", fasta, "--trees", trees_path,
                                      "--replicates", str(TOPOTEST_REPLICATES)])
    with contextlib.redirect_stdout(io.StringIO()):
        return run_topotest(args, timings)


# Card against CPU, the supports' and tests' shares: the two devices'
# float32 per-site rows differ by about 1e-7 relative, so a replicate whose
# statistic lies that close to its threshold (SH-aLRT's null against the
# observed statistic, a near-tied RELL argmax) may count the other way. At
# 24 x 300 a branch of small aLRT had 4 such replicates of 200 on an H100
# (PERF.md). The AU p-value is a fit to each scale's win share, which a
# vote moves further.
SHARE_TOL, AU_TOL = 0.05, 0.1


def close_supports(card: dict, cpu: dict) -> dict:
    """Card against CPU of one support command's JSON: the same keys and
    non-float values; likelihoods within rtol K34_RTOL; ``alrt`` and
    ``delta`` within 1e-2; every support, share or p-value within
    SHARE_TOL (``p_au`` AU_TOL); counts within 2. Returns the largest
    differences seen; raises past a limit."""
    worst = {"likelihood_rel": 0.0, "share": 0.0, "p_au": 0.0, "count": 0, "alrt": 0.0}
    if list(card) != list(cpu):
        raise AssertionError(f"keys differ: {list(card)} != {list(cpu)}")

    def walk(a, b, key):
        if isinstance(b, dict):
            if list(a) != list(b):
                raise AssertionError(f"{key}: keys differ")
            for k in b:
                walk(a[k], b[k], k)
        elif isinstance(b, list):
            if len(a) != len(b):
                raise AssertionError(f"{key}: lengths differ")
            for x, y in zip(a, b):
                walk(x, y, key)
        elif key == "tree" and isinstance(b, str):
            if strip_supports(a) != strip_supports(b):
                raise AssertionError("trees differ")
        elif b is None or isinstance(b, (str, bool)):
            if a != b:
                raise AssertionError(f"{key}: {a} != {b}")
        elif key in ("log_likelihood", "neg_log_likelihood", "ranking_score"):
            worst["likelihood_rel"] = max(worst["likelihood_rel"], abs(a - b) / abs(b))
        elif key in ("alrt", "delta", "mean_branch_length"):
            worst["alrt"] = max(worst["alrt"], abs(a - b))
        elif isinstance(b, int):
            worst["count"] = max(worst["count"], abs(a - b))
        elif key == "p_au":
            worst["p_au"] = max(worst["p_au"], abs(a - b))
        else:
            worst["share"] = max(worst["share"], abs(a - b))

    walk(card, cpu, "")
    if (worst["likelihood_rel"] > K34_RTOL or worst["alrt"] > 1e-2 or worst["count"] > 2
            or worst["share"] > SHARE_TOL or worst["p_au"] > AU_TOL):
        raise AssertionError(f"card {card} != cpu {cpu}: {worst}")
    return worst


def supports_reference(torch, workdir: str) -> list[dict]:
    """Slice 4a on the card against the CPU at 24 x 300, both devices under
    the same draws: ``infer --criterion ml`` with ``--alrt``, ``--ufboot``,
    both, and ``--model gtr --alrt``; ``topotest`` (JC and GTR, the AU
    test on); ``bootstrap`` (32 x 300); the host tree tools once."""
    fasta = os.path.join(workdir, "ref_4a.fasta")
    simulate_fasta(fasta, REF_SHAPE["n_taxa"], REF_SHAPE["n_sites"], SEED + 21,
                   branch=(0.1, 0.4))
    rows = []
    tree_path = os.path.join(workdir, "ref_4a_ml.nwk")
    with short_fits(REF_FIT_STEPS):
        for flags in (["--alrt", "200"], ["--ufboot", "200"], ["--alrt", "200", "--ufboot", "200"],
                      ["--model", "gtr", "--alrt", "200"]):
            argv = ["infer", "--alignment", fasta, "--criterion", "ml", "--neighborhood", "nni",
                    *flags]
            card = run_cli(argv).out
            cpu = run_cli(argv + ["--device", "cpu", "--output-tree", tree_path]).out
            worst = close_supports(card, cpu)
            rows.append(dict(command="infer --criterion ml " + " ".join(flags), worst=worst,
                             mean_support=float(np.mean(cpu.get("ufboot_support")
                                                        or cpu["sh_alrt_support"]))))
        from trex_tpu_torch.cli._common import _load_alignment

        names = _load_alignment(fasta, "dna")[0]
        trees = os.path.join(workdir, "ref_4a_trees.nwk")
        from trex_tpu_torch.io import save_newick
        from trex_tpu_torch.topology import random_topologies

        randoms = random_topologies(SEED + 22, REF_SHAPE["n_taxa"], 3, "cpu")
        others = [save_newick(type(randoms)(randoms.children[i], randoms.parents[i]), names)
                  for i in range(3)]
        with open(trees, "w") as fh:
            fh.write(strip_supports(open(tree_path).read()) + "\n" + "\n".join(others) + "\n")
        other_path = os.path.join(workdir, "ref_4a_other.nwk")
        with open(other_path, "w") as fh:
            fh.write(others[0] + "\n")
        for model in ("jc", "gtr"):
            argv = ["topotest", "--alignment", fasta, "--trees", trees, "--replicates", "1000",
                    "--model", model]
            card = run_cli(argv)[0]
            cpu = run_cli(argv + ["--device", "cpu"])[0]
            worst = close_supports(card, cpu)
            rows.append(dict(command=f"topotest --model {model}", worst=worst,
                             best=cpu["best"]))
    argv = ["bootstrap", "--leaves", "32", "--sites", "300", "--replicates", "10"]
    card = run_cli(argv)[0]
    cpu = run_cli(argv + ["--device", "cpu"])[0]
    if card != cpu:
        raise AssertionError(f"bootstrap: card {card} != cpu {cpu}")
    rows.append(dict(command=" ".join(argv), same_json=True))
    for argv in (["consensus", trees], ["treedist", tree_path, other_path],
                 ["stats", "--alignment", fasta], ["treedraw", "--tree", tree_path],
                 ["concord", "--tree", tree_path, "--gene-trees", trees, "--fasta", fasta]):
        out = run_cli(argv)
        rows.append(dict(command=argv[0], ran=True,
                         keys=list(out) if isinstance(out, dict) else None))
    return rows


# Slice 5 (Bayesian): ``mcmc``, ``date`` and ``bayesfactor`` on a 64 x 2048
# alignment simulated down a Kingman tree (JC69, root near 0.3), the JAX
# package's MCMC benchmark width; every chain batch goes through K4.
BAYES_SHAPE = dict(n_taxa=64, n_sites=2048)
MCMC_ARGS = ["--runs", "2", "--chains", "4", "--proposal", "informed", "--informed-power",
             "0.1", "--branch-moves", "2"]
MCMC_GENERATIONS = 500  # the JAX benchmark's 10,000, cut to fit the call
MCMC_SHORT = 100  # the --proposal nni and --full-bayes runs, and the resume
# Steady-state windows (``steady_window``): generations timed, and
# generations profiled (tracing costs about 0.2 ms an event, and mcmc
# launches about 2,000 a generation).
MCMC_WINDOW = 20  # one sample block of mcmc
SAMPLER_WINDOW = 30  # date and bayesfactor
PROFILED_GENERATIONS = 10
DATE_STRICT_GENERATIONS = 500  # the command's 4000, cut to fit the call
DATE_RELAXED_GENERATIONS = 300
# The clock fits of date (clock_lrt's two, 600 Adam steps each, and the
# sampler's start fit, 500) cut to this many steps: at 64 x 2048 they take
# about 28 ms a step on an H100 (47 s of a 59 s strict run at full length).
CLOCK_FIT_STEPS = 60
BAYESFACTOR_GENERATIONS = 200
BAYES_REF_SHAPE = dict(n_taxa=10, n_sites=300)
BAYES_REF_GENERATIONS = 60


def simulate_ultrametric(fasta: str, tree_path: str, n_taxa: int, n_sites: int, seed: int,
                         theta: float = 0.15) -> None:
    """A JC69 alignment down a Kingman coalescent tree (coalescence rate
    k (k - 1) / 2 / theta, so the root lies near 2 theta), and the tree
    with its ultrametric lengths as newick."""
    from trex_tpu_torch.io import save_newick
    from trex_tpu_torch.topology import from_numpy

    rng = np.random.default_rng(seed)
    active = list(range(n_taxa))
    ages = np.zeros(2 * n_taxa - 1)
    children = np.zeros((n_taxa - 1, 2), np.int32)
    t = 0.0
    for a in range(n_taxa - 1):
        k = len(active)
        t += rng.exponential(theta / (k * (k - 1) / 2))
        i, j = sorted(rng.choice(k, size=2, replace=False), reverse=True)
        x, y = active.pop(i), active.pop(j)
        children[a] = (min(x, y), max(x, y))
        ages[n_taxa + a] = t
        active.append(n_taxa + a)
    parents = np.full(2 * n_taxa - 1, 2 * n_taxa - 2, np.int32)
    for a, (x, y) in enumerate(children):
        parents[x] = parents[y] = n_taxa + a
    lengths = ages[parents] - ages
    lengths[-1] = 0.0
    seqs = np.empty((2 * n_taxa - 1, n_sites), np.int64)
    seqs[-1] = rng.integers(0, 4, n_sites)
    for a in range(n_taxa - 2, -1, -1):
        for c in children[a]:
            p_change = 0.75 * (1.0 - np.exp(-4.0 / 3.0 * lengths[c]))
            s = seqs[n_taxa + a].copy()
            hit = rng.random(n_sites) < p_change
            s[hit] = rng.integers(0, 4, int(hit.sum()))
            seqs[c] = s
    names = [f"taxon{i}" for i in range(n_taxa)]
    letters = np.frombuffer(b"ACGT", dtype=np.uint8)
    with open(fasta, "w") as fh:
        for i in range(n_taxa):
            fh.write(f">{names[i]}\n{letters[seqs[i]].tobytes().decode()}\n")
    with open(tree_path, "w") as fh:
        fh.write(save_newick(from_numpy(children, parents), names, branch_lengths=lengths)
                 + "\n")


def steady_window(torch, run, generations: int, profiled: int, repeats: int = 2) -> dict:
    """A sampler's steady state, its setup and summaries taken out.
    ``run(n, timings)`` samples ``n`` generations and puts the sampler's
    wall in ``timings["sampler"]``. Walls: the least of ``repeats``
    unprofiled runs of ``generations`` and of twice as many; launches and
    device-busy seconds: a run of ``profiled`` generations and one of
    twice as many under ``torch.profiler``. In each pair the second less
    the first is the steady state: ms, launches and busy seconds a
    generation, the idle share, the top kernels of ``profiled``
    generations."""
    walls = []
    for n in (generations, 2 * generations):
        best = math.inf
        for _ in range(repeats):
            timings: dict = {}
            run(n, timings)
            best = min(best, timings["sampler"])
        walls.append(best)
    profiles = []
    for n in (profiled, 2 * profiled):
        profiles.append(device_events(torch, lambda: run(n, {}))[0])
    short, long_ = profiles
    diff = {name: (count - short.get(name, (0, 0.0))[0], seconds - short.get(name, (0, 0.0))[1])
            for name, (count, seconds) in long_.items()}
    ms = 1e3 * (walls[1] - walls[0]) / generations
    busy_ms = 1e3 * sum(seconds for _, seconds in diff.values()) / profiled
    launches = sum(count for count, _ in diff.values())
    return dict(generations=generations, sampler_walls_s=walls, ms_per_generation=ms,
                profiled_generations=profiled, launches_per_generation=launches / profiled,
                device_busy_ms_per_generation=busy_ms, idle_share=1.0 - busy_ms / ms,
                top=top_events(diff))


def k4_bayes_at(torch, dev, children, leaves, weights, prior, pmats, timer,
                per_site: bool = False) -> dict:
    """K4 (a P a branch and tree) held within rtol K34_RTOL of its plain
    version at one of the samplers' batches, timed (ms, back to back, the
    plain version, device ms of a CUDA graph), beside its bound."""
    from trex_tpu_torch.ops.likelihood_cuda import (
        batched_log_likelihood_cuda,
        batched_log_likelihood_plain,
    )

    def run(fn):
        if not per_site:
            return lambda: fn(children, leaves, weights, prior, pmats, sequences_are_masks=True)

        def call():
            sums, rows = fn(children, leaves, weights, prior, pmats, sequences_are_masks=True,
                            per_site=True)
            return torch.cat([sums[:, None], rows], dim=1)
        return call

    batch, n_taxa, n_sites = children.shape[0], leaves.shape[0], int((weights != 0).sum())
    n_bytes, n_ops = k34_work(batch, n_taxa, n_sites, 4, True)
    if per_site:
        n_bytes += 4.0 * batch * (n_sites - 1)
    got = measure(torch, run(batched_log_likelihood_cuda), run(batched_log_likelihood_plain),
                  n_bytes, n_ops, rtol=K34_RTOL, plain_reps=2)
    return dict(trees=batch, n_taxa=n_taxa, patterns=n_sites, per_site=per_site, **got,
                **timer(run(batched_log_likelihood_cuda), got["ms"]))


def bayes_routes(torch, dev, workdir: str, reset_counts, launch_counts, timer) -> dict:
    """Slice 5 on the card at 64 x 2048 (every launch count set to 0 just
    before each route and read just after): ``mcmc`` informed (2 runs x 4
    chains, 2 branch moves) for MCMC_GENERATIONS, a steady-state window
    (``steady_window``) of MCMC_WINDOW generations, one whole sample
    block of the fixed-model sampler under ``torch.cuda.set_sync_debug_mode("error")``, short
    ``--proposal nni`` and ``--full-bayes`` runs (the latter counting the
    syncs of its eigensystems), a ``--checkpoint-dir``/``--stop-after``
    resume held bit for bit against the uninterrupted run; ``date`` strict
    at DATE_STRICT_GENERATIONS and relaxed under a coalescent prior
    (Ne sampled) with one calibrated clade; ``bayesfactor --models jc,gtr``
    at 32 rungs; K4 at the samplers' batches (the branch moves' 8 trees,
    the stepping-stone's 32, the +G per-site 8 x 4) and the informed
    neighbourhood scored directly by K4 beside ``nni_scan``; the renumber
    pass's cost. Returns what the kernels line reads."""
    from trex_tpu_torch.alignment import compress_alignment
    from trex_tpu_torch.cli._common import _load_alignment
    from trex_tpu_torch.io import load_newick, sample_topologies
    from trex_tpu_torch.ops.likelihood import discrete_gamma_rates, jc69_transition
    from trex_tpu_torch.ops.likelihood_cuda import batched_log_likelihood_cuda
    from trex_tpu_torch.ops.nni_scan import nni_neighborhood_lnl
    from trex_tpu_torch.ops.tree_moves import nni_neighborhood_device, renumber_topological
    from trex_tpu_torch.search import dating, mcmc
    from trex_tpu_torch.search.marginal import stepping_stone

    found: dict = {"launches": {}}
    fasta = os.path.join(workdir, "bayes.fasta")
    tree_path = os.path.join(workdir, "bayes_true.nwk")
    simulate_ultrametric(fasta, tree_path, BAYES_SHAPE["n_taxa"], BAYES_SHAPE["n_sites"],
                         SEED + 31)
    names, masks, _ = _load_alignment(fasta, "dna")
    patterns, counts = compress_alignment(masks)
    pat_t = torch.as_tensor(patterns.astype(np.int32), device=dev)
    w_t = torch.as_tensor(counts.astype(np.float32), device=dev)
    n_taxa = len(names)

    def route(argv, **kwargs):
        reset_counts()
        out, wall = timed_cli(torch, argv, **kwargs)
        launches = launch_counts()
        if launches["k34_per_branch"] <= 0:
            raise AssertionError(f"{argv[0]}: K4 never launched ({launches})")
        return out, wall, launches

    # mcmc, informed: the JAX package's benchmark point, generations cut.
    mcmc_argv = ["mcmc", "--fasta", fasta, *MCMC_ARGS]
    seconds: dict = {}
    out, wall, launches = route(mcmc_argv + ["--generations", str(MCMC_GENERATIONS)],
                                timings=seconds)
    if not (out["n_samples"] > 0 and np.isfinite(out["mean_lnl"])
            and out["consensus_tree"].endswith(";") and 0 < out["acceptance"]["branch"] <= 1):
        raise AssertionError(f"mcmc route: {out}")
    found["launches"]["mcmc"] = launches
    mcmc_kw = dict(n_runs=2, n_chains=4, topo_proposal="informed", topo_informed_power=0.1,
                   branch_moves_per_gen=2, site_weights=w_t, sequences_are_masks=True,
                   device=dev)
    window = steady_window(torch, lambda n, timings: mcmc.mcmc_sample(
        pat_t, 4, seed=SEED, n_generations=n, sample_every=MCMC_WINDOW, timings=timings,
        **mcmc_kw), MCMC_WINDOW, PROFILED_GENERATIONS)
    found["mcmc"] = dict(generations=MCMC_GENERATIONS, wall_s=wall,
                         generations_per_s=MCMC_GENERATIONS / wall,
                         sampler_s=seconds["sampler"],
                         sampler_generations_per_s=MCMC_GENERATIONS / seconds["sampler"],
                         launches=launches,
                         k4_launches_per_generation=launches["k34"] / MCMC_GENERATIONS,
                         window=window)
    emit("bayes_mcmc", command="mcmc " + " ".join(MCMC_ARGS)
         + f" --generations {MCMC_GENERATIONS} (64 x 2048)", unique_patterns=out[
             "unique_patterns"], mean_lnl=out["mean_lnl"], acceptance=out["acceptance"],
         asdsf=out["asdsf"], ess_lnl=out["ess_lnl"], n_samples=out["n_samples"],
         **found["mcmc"])

    # One whole sample block of the fixed-model sampler (the informed
    # proposal, JC) under the sync debugger: a host sync inside a
    # generation raises.
    blocks = mcmc.run_blocks
    guarded = {"blocks": 0}

    def checked(*args, **kwargs):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            return blocks(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode(0)
            guarded["blocks"] += args[1]

    mcmc.run_blocks = checked
    try:
        mcmc.mcmc_sample(pat_t, 4, seed=SEED + 1, n_generations=40, sample_every=20, **mcmc_kw)
    finally:
        mcmc.run_blocks = blocks
    emit("bayes_sync_free_block", sampler="mcmc informed JC (64 x 2048, 8 chains)",
         blocks_under_sync_debug_error=guarded["blocks"], generations_a_block=20)

    # The uniform proposal and full Bayes, short; full Bayes syncs where
    # each chain's eigensystem (torch.linalg.eigh) does: counted.
    short = {}
    for name, extra in (("nni", ["--proposal", "nni"]), ("full_bayes", ["--full-bayes"])):
        argv = ["mcmc", "--fasta", fasta, *MCMC_ARGS, *extra, "--generations", str(MCMC_SHORT)]
        with short_fits(REF_FIT_STEPS):
            out, wall, launches = route(argv)
        short[name] = dict(wall_s=wall, generations_per_s=MCMC_SHORT / wall, launches=launches,
                           mean_lnl=out["mean_lnl"], acceptance=out["acceptance"])
        found["launches"][f"mcmc_{name}"] = launches
    import warnings

    # A first call builds cuSOLVER's handle and workspace; the second's
    # syncs are counted.
    eig = mcmc.gtr_eigensystem_batched(
        torch.as_tensor(np.full((8, 4, 4), 1.0, np.float32), device=dev),
        torch.full((8, 4), 0.25, device=dev))
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            eig = mcmc.gtr_eigensystem_batched(
                torch.as_tensor(np.full((8, 4, 4), 1.0, np.float32), device=dev),
                torch.full((8, 4), 0.25, device=dev))
        finally:
            torch.cuda.set_sync_debug_mode(0)
    eig_syncs = sum("synchroniz" in str(w.message) for w in caught)
    del eig
    short["full_bayes"].update(syncs_a_batched_eigensystem=eig_syncs,
                               eigensystems_a_generation=2 + 2 * 2)
    emit("bayes_mcmc_short", generations=MCMC_SHORT, **short)

    # Resume: stopped halfway and resumed, against the
    # uninterrupted run, bit for bit (K4 has no float atomics).
    resume = {}
    stop = MCMC_SHORT // 2
    for name, extra in (("whole", []), ("stopped", ["--stop-after", str(stop)]), ("resumed", [])):
        ck_dir = os.path.join(workdir, "mcmc_ck_" + ("whole" if name == "whole" else "legs"))
        out, _ = timed_cli(torch, ["mcmc", "--fasta", fasta, *MCMC_ARGS, "--generations",
                                   str(MCMC_SHORT), "--checkpoint-dir", ck_dir,
                                   "--checkpoint-every", str(stop), *extra])
        resume[name] = (out, dict(np.load(os.path.join(ck_dir, "mcmc_checkpoint.npz"))))
    whole, legs = resume["whole"], resume["resumed"]
    for key in whole[1]:
        if not np.array_equal(whole[1][key], legs[1][key]):
            raise AssertionError(f"mcmc resume: {key} differs from the uninterrupted run")
    if whole[0] != legs[0]:
        raise AssertionError("mcmc resume: JSON differs from the uninterrupted run")
    emit("bayes_mcmc_resume", generations=MCMC_SHORT, stopped_at=stop, bit_identical=True,
         mean_lnl=whole[0]["mean_lnl"])

    # date: strict at DATE_STRICT_GENERATIONS, then relaxed under a
    # coalescent prior (Ne sampled) with one calibrated clade; the command's
    # walls by part from its timings.
    topo, true_lengths, tree_names = load_newick(open(tree_path).read())
    clade = sorted(dating_clade(topo))
    true_topo = topo.to(dev)
    ages = true_ages(topo, true_lengths)
    date_runs = {}
    for name, extra, gens, kw in (
            ("strict", [], DATE_STRICT_GENERATIONS, {}),
            ("relaxed_coalescent_calibrated",
             ["--clock", "relaxed", "--tree-prior", "coalescent", "--calibrate",
              ",".join(tree_names[i] for i in clade) + ":0.05:0.5"],
             DATE_RELAXED_GENERATIONS,
             dict(clock="relaxed", tree_prior="coalescent",
                  calibrations={frozenset(clade): (0.05, 0.5)}))):
        seconds = {}
        out, wall, launches = route(["date", "--fasta", fasta, "--tree", tree_path,
                                     "--generations", str(gens), *extra], timings=seconds,
                                    clock_iterations=CLOCK_FIT_STEPS)
        if not (np.isfinite(out["root_age"]["mean"]) and out["tree"].endswith(";")):
            raise AssertionError(f"date {name}: {out}")
        window = steady_window(torch, lambda n, timings: dating.mcmc_date(
            true_topo, pat_t, 4, seed=SEED, n_generations=n, start_ages=ages,
            site_weights=w_t, sequences_are_masks=True, device=dev, timings=timings, **kw),
            SAMPLER_WINDOW, PROFILED_GENERATIONS)
        date_runs[name] = dict(generations=gens, clock_fit_steps=CLOCK_FIT_STEPS, wall_s=wall,
                               clock_lrt_s=seconds["clock_lrt"],
                               start_fit_s=seconds["start_fit"], sampler_s=seconds["sampler"],
                               generations_per_s=gens / seconds["sampler"], launches=launches,
                               k4_launches_per_generation=launches["k34"] / gens,
                               window=window, root_age=out["root_age"],
                               true_root_age=float(ages[-1]), acceptance=out["acceptance"],
                               clock_lrt=out["clock_lrt"])
        found["launches"][f"date_{name}"] = launches
    found["date"] = date_runs
    emit("bayes_date", n_taxa=n_taxa, calibrated_clade_size=len(clade), **date_runs)

    # bayesfactor: jc and gtr at 32 rungs.
    seconds = {}
    out, wall, launches = route(["bayesfactor", "--fasta", fasta, "--tree", tree_path,
                                 "--models", "jc,gtr", "--rungs", "32", "--generations",
                                 str(BAYESFACTOR_GENERATIONS)], timings=seconds)
    if not all(np.isfinite(v["log_marginal"]) for v in out["models"].values()):
        raise AssertionError(f"bayesfactor: {out}")
    bf_window = {}
    for model in ("jc", "gtr"):
        bf_window[model] = steady_window(torch, lambda n, timings: stepping_stone(
            true_topo, pat_t, 4, seed=SEED, n_rungs=32, n_generations=n,
            sample_model=model == "gtr", site_weights=w_t, sequences_are_masks=True,
            device=dev, timings=timings), SAMPLER_WINDOW, PROFILED_GENERATIONS)
    sampler_s = {model: seconds[model]["sampler"] for model in ("jc", "gtr")}
    found["bayesfactor"] = dict(generations=BAYESFACTOR_GENERATIONS, wall_s=wall,
                                sampler_s=sampler_s,
                                generations_per_s={m: BAYESFACTOR_GENERATIONS / x
                                                   for m, x in sampler_s.items()},
                                launches=launches,
                                window=bf_window, models=out["models"], best=out["best"])
    found["launches"]["bayesfactor"] = launches
    emit("bayes_bayesfactor", **found["bayesfactor"])

    # K4 at the samplers' batches: the chains' start trees (8), the rungs'
    # copies of the true tree (32), the +G chains x categories (32).
    rng = np.random.default_rng(SEED + 32)
    starts = sample_topologies(int(rng.integers(2**31)), n_taxa, 8, device=dev).children
    lengths = torch.as_tensor(rng.exponential(0.1, (8, 2 * n_taxa - 1)).astype(np.float32),
                              device=dev)
    uniform = torch.full((4,), 0.25, device=dev)
    at = {}
    at["branch_moves"] = k4_bayes_at(torch, dev, starts, pat_t, w_t, uniform,
                                     jc69_transition(lengths, 4).contiguous(), timer)
    rungs = true_topo.children[None].expand(32, -1, -1).contiguous()
    rung_lengths = torch.as_tensor(rng.exponential(0.1, (32, 2 * n_taxa - 1)).astype(
        np.float32), device=dev)
    at["stepping_stone"] = k4_bayes_at(torch, dev, rungs, pat_t, w_t, uniform,
                                       jc69_transition(rung_lengths, 4).contiguous(), timer)
    cats = discrete_gamma_rates(torch.tensor(0.5, device=dev), 4)
    scaled = (lengths[:, None, :] * cats[None, :, None]).reshape(32, -1)
    at["gamma_per_site"] = k4_bayes_at(
        torch, dev, starts.repeat_interleave(4, dim=0), pat_t, w_t, uniform,
        jc69_transition(scaled, 4).contiguous(), timer, per_site=True)
    nbr_c, nbr_l = nni_neighborhood_device(starts, lengths, n_taxa)
    flat_c = nbr_c.reshape(-1, n_taxa - 1, 2).contiguous()
    flat_p = jc69_transition(nbr_l.reshape(-1, 2 * n_taxa - 1), 4).contiguous()
    direct = k4_bayes_at(torch, dev, flat_c, pat_t, w_t, uniform, flat_p, timer)
    scan = lambda: nni_neighborhood_lnl(starts, lengths, pat_t, 4, site_weights=w_t,  # noqa
                                        sequences_are_masks=True)
    scan_vals = scan()
    direct_vals = batched_log_likelihood_cuda(flat_c, pat_t, w_t, uniform, flat_p,
                                              sequences_are_masks=True).view(8, -1)
    scan_rel = float(((scan_vals - direct_vals).abs() / direct_vals.abs()).max())
    if scan_rel > 1e-5:
        raise AssertionError(f"nni_scan differs from K4 on the neighbourhood: {scan_rel}")
    build = lambda: jc69_transition(  # noqa: E731
        nni_neighborhood_device(starts, lengths, n_taxa)[1].reshape(-1, 2 * n_taxa - 1), 4)
    at["informed_neighbourhood_direct"] = dict(
        direct, nni_scan_ms=time_ms(torch, scan, 10), nni_scan_max_rel_diff=scan_rel,
        neighbourhood_build_ms=time_ms(torch, build, 10),
        note="the neighbourhood scored as 992 trees by K4 (the JAX fallback), for the record")
    renumber_ms = time_ms(torch, lambda: renumber_topological(nbr_c[:, 0].contiguous(), n_taxa),
                          10)
    found["k4"] = at
    found["renumber_ms"] = renumber_ms
    emit("bayes_k4", renumber_topological_ms_8_chains=renumber_ms, **at)
    return found


def dating_clade(topo) -> frozenset:
    """A clade of 4 to 16 leaves of the tree (the calibrated one): the
    first ancestor in index order of that size."""
    from trex_tpu_torch.search.bootstrap import subtree_leaf_sets

    return next(s for s in subtree_leaf_sets(topo) if 4 <= len(s) <= 16)


def true_ages(topo, lengths) -> np.ndarray:
    """(n_all,) float32 node ages of an ultrametric tree from its lengths
    (leaves at 0; an ancestor's age its first child's plus that child's
    length)."""
    children = topo.children.cpu().numpy()
    n_leaves = children.shape[0] + 1
    ages = np.zeros(2 * n_leaves - 1)
    for a, (c, _) in enumerate(children):
        ages[n_leaves + a] = ages[c] + lengths[c]
    return ages.astype(np.float32)


def bayes_fields(bayes: dict) -> dict:
    """The K3/K4 entry's fields from the bayes phase: K4's grids on each
    Bayesian route by mode, and K4 held at the samplers' batches."""
    if not bayes:
        return {}
    return {
        "bayes_route_launches": {
            route: {k: v[k] for k in ("k34", "k34_per_branch", "k34_per_site", "k34_shared")}
            for route, v in bayes["launches"].items()},
        "at_bayes_batches": bayes["k4"],
    }


def bayes_entry(bayes: dict) -> dict | None:
    """K3/K4's kernels-line entry from the bayes phase alone (a run of a
    subset of the phases): held and timed at the branch moves' batch,
    launches on the mcmc route."""
    if not bayes:
        return None
    first = bayes["k4"]["branch_moves"]
    return {
        "name": "likelihood_batched", "route": "cuda",
        "source": "trex_tpu_torch/csrc/likelihood_batched.cu",
        "replaces": "trex_tpu/ops/likelihood_pallas.py:135",
        "launches": bayes["launches"]["mcmc"]["k34"],
        **{k: first[k] for k in ("max_abs_err", "max_rel_err", "ms", "plain_ms", "bound_ms",
                                 "bound_by", "device_ms")},
        "library_ms": None, **bayes_fields(bayes),
    }


def same_chains(name: str, card, cpu, scale: float) -> None:
    """Card against CPU of one sampler's outputs: arrays of integers (and
    the accept counts) equal, floats within rtol K34_RTOL of ``scale``
    (the chains' |lnL|) or of themselves."""
    for key in card:
        a, b = np.asarray(card[key]), np.asarray(cpu[key])
        if a.dtype.kind in "iub":
            if not np.array_equal(a, b):
                raise AssertionError(f"{name}: {key} differs between card and CPU")
        elif not np.allclose(a, b, rtol=K34_RTOL, atol=K34_RTOL * (scale if key.endswith(
                "lnl") else 1e-2)):
            raise AssertionError(f"{name}: {key} differs between card and CPU: "
                                 f"{np.abs(a - b).max()}")


def q5_alignment(n_taxa: int, n_sites: int, seed: int):
    """(patterns, counts) of 5-state characters evolved down a random tree
    (each site changes with probability 0.15 an edge), 5% missing (-1)."""
    from trex_tpu_torch.alignment import compress_alignment

    rng = np.random.default_rng(seed)
    children = random_trees(rng, n_taxa, 1)[0]
    seqs = np.empty((2 * n_taxa - 1, n_sites), np.int64)
    seqs[-1] = rng.integers(0, 5, n_sites)
    for a in range(n_taxa - 2, -1, -1):
        for c in children[a]:
            s = seqs[n_taxa + a].copy()
            hit = rng.random(n_sites) < 0.15
            s[hit] = rng.integers(0, 5, int(hit.sum()))
            seqs[c] = s
    states = seqs[:n_taxa].astype(np.int32)
    states[rng.random(states.shape) < 0.05] = -1
    patterns, counts = compress_alignment(states)
    return np.asarray(patterns, np.int32), np.asarray(counts, np.float32)


def bayes_reference(torch, workdir: str) -> list[dict]:
    """Slice 5 on the card against the CPU at BAYES_REF_SHAPE, each sampler
    from one draw source (a CPU generator's draws, moved to the run's
    device): the same accepts, children and samples, lnL and lengths within
    rtol K34_RTOL; accepts whose log u lies within 1e-5 of log alpha (and
    within 1e-6 |lnL|) counted. The informed sampler also runs at Q = 5
    (``q5_alignment``, K4's runtime-Q kernel), with its gen/s on each
    device."""
    from trex_tpu_torch.alignment import compress_alignment
    from trex_tpu_torch.cli._common import _load_alignment
    from trex_tpu_torch.io import load_newick
    from trex_tpu_torch.search import dating, mcmc
    from trex_tpu_torch.search.marginal import stepping_stone

    fasta = os.path.join(workdir, "bayes_ref.fasta")
    tree_path = os.path.join(workdir, "bayes_ref.nwk")
    simulate_ultrametric(fasta, tree_path, BAYES_REF_SHAPE["n_taxa"], BAYES_REF_SHAPE["n_sites"],
                         SEED + 33)
    _, masks, _ = _load_alignment(fasta, "dna")
    patterns, counts = compress_alignment(masks)
    topo, lengths, _ = load_newick(open(tree_path).read())
    ages = true_ages(topo, lengths)
    gens = BAYES_REF_GENERATIONS
    gtr = (np.array([[0, 1.2, 4.0, 0.6], [1.2, 0, 0.9, 3.3], [4.0, 0.9, 0, 1.0],
                     [0.6, 3.3, 1.0, 0]], np.float32), np.array([0.3, 0.2, 0.22, 0.28],
                                                                np.float32))
    clade = frozenset(sorted(dating_clade(topo)) if topo.n_leaves > 8 else [0, 1])
    runs = {
        "mcmc informed jc": ("mcmc", dict(n_runs=2, n_chains=2, branch_moves_per_gen=2)),
        "mcmc nni gtr+g": ("mcmc", dict(n_runs=1, n_chains=3, topo_proposal="nni",
                                        rates=gtr[0], freqs=gtr[1], gamma_shape=0.6)),
        "mcmc informed gtr+g": ("mcmc", dict(n_runs=1, n_chains=2, rates=gtr[0],
                                             freqs=gtr[1], gamma_shape=0.6)),
        "mcmc informed full bayes": ("mcmc", dict(n_runs=1, n_chains=2, sample_model=True)),
        "date strict": ("date", {}),
        "date relaxed coalescent calibrated": ("date", dict(
            clock="relaxed", tree_prior="coalescent", calibrations={clade: (0.01, 1.0)})),
        "date tip-dated": ("date", dict(tip_ages=np.linspace(0.0, 0.02, topo.n_leaves,
                                                             dtype=np.float32))),
        "bayesfactor jc": ("ss", {}),
        "bayesfactor gtr": ("ss", dict(sample_model=True)),
        # K4's runtime-Q kernel in the sampler: 5-state characters with
        # missing data (tests/test_torch_mcmc_any_q.py's case, at 10 x 300).
        "mcmc informed q5": ("mcmc", dict(n_runs=1, n_chains=2, n_states=5)),
    }
    q5_patterns, q5_counts = q5_alignment(BAYES_REF_SHAPE["n_taxa"], BAYES_REF_SHAPE["n_sites"],
                                          SEED + 36)
    rows = []
    for name, (kind, kw) in runs.items():
        outs, margins, walls = {}, {"cuda": [], "cpu": []}, {}
        kw = dict(kw)
        q = kw.pop("n_states", 4)
        accept = mcmc.metropolis_accept
        try:
            for device in ("cuda", "cpu"):
                def recording(u, log_alpha, seen=margins[device]):
                    seen.append((torch.log(u) - log_alpha).cpu().numpy().ravel())
                    return accept(u, log_alpha)

                mcmc.metropolis_accept = recording
                draws = mcmc.TorchDraws(torch.Generator("cpu").manual_seed(SEED + 34),
                                        device=device)
                common = dict(seed=SEED + 35, draws=draws, device=device, site_weights=counts,
                              sequences_are_masks=True)
                if kind == "mcmc":
                    ck = os.path.join(workdir, f"bayes_ref_{device}")
                    shutil.rmtree(ck, ignore_errors=True)
                    leaves = patterns.astype(np.int32)
                    if q != 4:
                        leaves = q5_patterns
                        common.update(site_weights=q5_counts, sequences_are_masks=False)
                    if device == "cuda":
                        torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    res = mcmc.mcmc_sample(leaves, q, n_generations=gens,
                                           sample_every=10, checkpoint_dir=ck, **common, **kw)
                    if device == "cuda":
                        torch.cuda.synchronize()
                    walls[device] = time.perf_counter() - t0
                    state = dict(np.load(os.path.join(ck, "mcmc_checkpoint.npz")))
                    state.pop("draws_state")
                    outs[device] = dict(state, sample_children=res.sample_children,
                                        acceptance=np.array(list(res.acceptance.values())))
                elif kind == "date":
                    res = dating.mcmc_date(topo, patterns.astype(np.int32), 4, n_generations=gens,
                                           start_ages=ages, **common, **kw)
                    outs[device] = dict(sample_ages=res.sample_ages, sample_lnl=res.sample_lnl,
                                        acceptance=np.array(list(res.acceptance.values())))
                else:
                    res = stepping_stone(topo, patterns.astype(np.int32), 4, n_rungs=8,
                                         n_generations=gens // 2, **common, **kw)
                    outs[device] = dict(log_ratios=res["log_ratios"],
                                        acceptance=np.array([res["acceptance"]]))
        finally:
            mcmc.metropolis_accept = accept
        card, cpu = (np.concatenate(margins[d]) for d in ("cuda", "cpu"))
        scale = float(np.abs(outs["cpu"].get("lnl", outs["cpu"].get("sample_lnl",
                                                                    [1.0]))).max())
        finite = np.abs(card[np.isfinite(card)])
        row = dict(sampler=name, generations=gens, decisions=int(card.size),
                   **({"n_states": q, "gen_per_s": {d: gens / w for d, w in walls.items()}}
                      if q != 4 else {}),
                   near_ties_within_1e_5=int((finite <= 1e-5).sum()),
                   near_ties_within_1e_6_lnl=int((finite <= 1e-6 * scale).sum()))
        # The first decision the devices took apart: none, or one whose log u
        # lies within 1e-6 |lnL| of log alpha on both (the devices' lnL differ
        # by about 1e-7 relative; ROADMAP.md, accepted differences), after
        # which the chains part.
        n = min(card.size, cpu.size)
        apart = np.nonzero((card[:n] < 0) != (cpu[:n] < 0))[0]
        if apart.size == 0 and card.size == cpu.size:
            same_chains(name, outs["cuda"], outs["cpu"], scale)
            rows.append(dict(row, same_accepts_and_children=True))
            continue
        first = int(apart[0]) if apart.size else n
        tied = (first < n and abs(card[first]) <= 1e-6 * scale
                and abs(cpu[first]) <= 1e-6 * scale)
        if not tied:
            raise AssertionError(
                f"{name}: card and CPU part at decision {first} of {n}, margins "
                f"{card[first] if first < n else None} and {cpu[first] if first < n else None}, "
                f"not a near tie (|lnL| {scale})")
        rows.append(dict(row, same_accepts_and_children=False, parted_at_near_tie=first,
                         margins=[float(card[first]), float(cpu[first])]))
    return rows


@contextlib.contextmanager
def short_fits(steps: int):
    """``ops.likelihood.optimize_model`` at ``steps`` Adam steps while the
    block runs (the commands look it up at call time)."""
    import functools

    from trex_tpu_torch.ops import likelihood

    full = likelihood.optimize_model
    likelihood.optimize_model = functools.partial(full, n_iterations=steps)
    try:
        yield
    finally:
        likelihood.optimize_model = full

# Slice 6 (models and simulation): ``simulate`` at the JAX package's scale
# harness size (benchmarks/scale_probe.py: 8192 taxa x 1024 sites, 16,383 x
# 1024 cells, the device path) and a host-walk run; GY94 codons at the
# samplers' 64-taxon width, ``dnds`` on them, and K3/K4's runtime-Q kernel
# at Q = 61 (and Q = 5) on their batches.
SIM_WIDE_ARGS = ["simulate", "--leaves", "8192", "--sites", "1024", "--model", "gtr+g"]
SIM_HOST_ARGS = ["simulate", "--leaves", "512", "--sites", "2048"]
DNDS_TRUTH = dict(kappa=2.0, omega=0.3)
DNDS_SIM_ARGS = ["simulate", "--model", "gy94", "--leaves", "64", "--sites", "1000",
                 "--kappa", str(DNDS_TRUTH["kappa"]), "--omega", str(DNDS_TRUTH["omega"])]
# The fitted omega and kappa beside the truth: the CPU's fit of the same
# alignment (the same seed, the command's defaults) came within 0.0006 of
# omega and 0.019 of kappa; the card's must come within 3x the latter,
# 0.06, and 0.01 of omega (the fits' 1e-2 agreement between devices).
DNDS_TOLERANCE = dict(kappa=0.06, omega=0.01)
DNDS_PROFILED_STEPS = 20
# ``dnds --search``'s two GY94+G fits cut from the command's 600 Adam steps
# (26.7 s of its 27.2 s on an H100) for the samplers' mesh phase.
DNDS_SEARCH_STEPS = 300
CODON_CLIMB_ROUNDS = 2
K34_Q61_WIDE = dict(n_taxa=512, n_sites=1000, batch=32)
K34_Q5 = dict(n_taxa=64, n_sites=1024, batch=256)
# The small-Q shapes at K34_Q5's size: Q on states and on masks (the fixed
# kernels' zero-padded widths 4 and 8); Q = 5 with a P per branch (the Q = 5
# sampler's mode); Q = 11 (width 12), 13 with a P per branch (width 16), 19
# on masks (width 20, padded); Q = 21, the first Q above the widest fixed
# kernel, and 25 on masks (the runtime-Q kernel's 32 pitch); Q = 100 (its
# runtime pitch), on K34_WIDE_Q_TREES trees.
K34_SMALL_Q = ((2, False, False), (2, True, False), (3, False, False), (3, True, False),
               (7, False, False), (7, True, False), (5, False, True), (11, False, False),
               (13, False, True), (19, True, False), (21, False, False), (25, True, False),
               (100, False, False))
K34_WIDE_Q_TREES = 32  # trees of a shape above 64 states (a pitch the kernel reads at run time)
MODELS_REF = dict(n_taxa=10, n_sites=300, iterations=50)


def k34_any_q(torch, dev, children, leaves, weights, prior, transition, timer,
              masks: bool = False, force_global: bool = False) -> dict:
    """K3/K4 at a runtime Q held within rtol K34_RTOL of its plain version,
    timed (ms, back to back, plain, device ms of a CUDA graph), with its
    launch plan, bound and the seconds the whole check took;
    ``force_global``: the kernel's global-slot mode at the same shape (the
    plan's width, its slots in global memory)."""
    from trex_tpu_torch._device import device_limits
    from trex_tpu_torch.ops import likelihood_cuda as lc

    t0 = time.perf_counter()
    q = prior.shape[0]
    per_branch = transition.dim() == 4
    plan = lc.launch_plan(leaves.shape[0], q, not per_branch, masks,
                          device_limits(dev).smem_optin)
    if force_global:
        plan = dataclasses.replace(plan, mode="global", smem_bytes=plan.smem_bytes
                                   - 4 * plan.slots * lc.slot_states(q) * plan.sites_per_block)

    def run(fn):
        return lambda: fn(children, leaves, weights, prior, transition, sequences_are_masks=masks)

    chosen = lc.launch_plan
    if force_global:
        lc.launch_plan = lambda *a: plan
    try:
        batch, n_taxa = children.shape[0], leaves.shape[0]
        got = measure(torch, run(lc.batched_log_likelihood_cuda),
                      run(lc.batched_log_likelihood_plain),
                      *k34_work(batch, n_taxa, int((weights != 0).sum()), q, per_branch),
                      rtol=K34_RTOL, plain_reps=2)
        times = timer(run(lc.batched_log_likelihood_cuda), got["ms"])
    finally:
        lc.launch_plan = chosen
    return dict(trees=batch, n_taxa=n_taxa, patterns=int(leaves.shape[1]), n_states=q,
                per_branch=per_branch, masks=masks, kernel_width=lc.kernel_width(q),
                plan=dataclasses.asdict(plan), **got, **times, seconds=time.perf_counter() - t0)


def small_q_inputs(torch, dev, rng, q: int, masks: bool, per_branch: bool,
                   size: dict | None = None):
    """(children, leaves, weights, prior, transition) of a K34_SMALL_Q shape
    (or of ``size``, a dict as K34_Q5): random trees, a GTR-like P at 0.1
    (or at random lengths a branch), 5%
    missing states and 0.2% states >= Q (such a leaf zeroes its site's
    likelihood), or masks with a bit at or above Q (below 8, or up to Q + 3
    from 8 states on) in 3% of them."""
    from trex_tpu_torch.ops.likelihood import gtr_generator

    n, length, batch = (size or K34_Q5).values()
    if size is None and q > 64:
        batch = K34_WIDE_Q_TREES
    rates = rng.gamma(2.0, 1.0, (q, q))
    prior = torch.as_tensor(rng.dirichlet(np.full(q, 5.0)).astype(np.float32), device=dev)
    gen = gtr_generator(torch.as_tensor((rates + rates.T) / 2, device=dev), prior)
    if per_branch:
        lengths = rng.uniform(0.02, 0.5, (batch, 2 * n - 1, 1, 1)).astype(np.float32)
        transition = torch.linalg.matrix_exp(gen * torch.as_tensor(lengths, device=dev))
    else:
        transition = torch.linalg.matrix_exp(gen * 0.1)
    if masks:
        leaves = rng.integers(1, 1 << q, (n, length))
        high = rng.random(leaves.shape) < 0.03
        leaves[high] |= 1 << rng.integers(q, 8 if q < 8 else q + 4, int(high.sum()))
    else:
        leaves = rng.integers(0, q, (n, length))
        leaves[rng.random(leaves.shape) < 0.05] = -1
        high = rng.random(leaves.shape) < 0.002
        leaves[high] = rng.integers(q, q + 4, int(high.sum()))
    return (torch.as_tensor(random_trees(rng, n, batch), device=dev),
            torch.as_tensor(leaves.astype(np.int32), device=dev),
            torch.ones((length,), device=dev), prior, transition.contiguous())


def simulate_routes(torch, dev, workdir: str, reset_counts, launch_counts) -> dict:
    """``simulate`` on the card: SIM_WIDE_ARGS (the device path: wall, depth
    levels, launches and idle share of a profiled run, peak memory; the
    leaves' composition against the model's frequencies, drawn from the
    seed as the command draws them; determinism), the device path's
    zero-length copies and invariant sites at the same size, and
    SIM_HOST_ARGS (the host walk; its FASTA byte-equal to ``--device
    cpu``'s)."""
    from trex_tpu_torch.cli._common import _load_alignment
    from trex_tpu_torch.models import simulate as sim
    from trex_tpu_torch.topology import balanced_topology

    found = {}
    wide = os.path.join(workdir, "sim_wide.fasta")
    argv = SIM_WIDE_ARGS + ["--output", wide]
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    timings: dict = {}
    _, wall = timed_cli(torch, argv, timings=timings)
    peak = torch.cuda.max_memory_allocated()
    counts = launch_counts()
    if timings["path"] != "device" or any(counts.values()):
        raise AssertionError(f"{' '.join(argv)}: {timings}, kernel launches {counts}")
    with open(wide) as fh:
        first = fh.read()
    profile = profile_phase(torch, lambda: run_cli(argv), wall)
    with open(wide) as fh:
        if fh.read() != first:
            raise AssertionError(f"{' '.join(argv)} is not deterministic under its seed")
    _, leaves, _ = _load_alignment(wide, "dna")
    states = np.argmax(leaves[..., None] == (1 << np.arange(4)), axis=-1)
    # The command's draws: the tree from its own generator, then lengths,
    # GTR rates and frequencies from default_rng(--seed).
    n_leaves, n_sites = int(SIM_WIDE_ARGS[2]), int(SIM_WIDE_ARGS[4])
    rng = np.random.default_rng(0)
    rng.exponential(0.1, size=(2 * n_leaves - 1,))
    rng.gamma(2.0, 1.0, size=6)
    freqs = rng.dirichlet(np.full(4, 10.0))
    observed = np.bincount(states.ravel(), minlength=4) / states.size
    # About four standard errors of the root's composition, which the
    # leaves share through the tree.
    if np.abs(observed - freqs).max() > 1.0 / n_sites**0.5:
        raise AssertionError(f"composition {observed} against the frequencies {freqs}")
    # The device path at the same size (16,383 x 1024 cells): zero lengths
    # copy the root; a 0.5 invariant share leaves exactly constant sites.
    topo = balanced_topology(n_leaves)
    copies, anc = sim.simulate_alignment(1, topo, np.zeros(topo.n_all), n_sites=n_sites,
                                         return_ancestors=True, device=dev)
    if not ((copies == anc[-1][None]).all() and (anc == anc[-1][None]).all()):
        raise AssertionError("zero-length branches did not copy the root on the device path")
    inv = sim.simulate_alignment(2, topo, np.full(topo.n_all, 0.1), n_sites=n_sites,
                                 gamma_shape=0.5, p_invariant=0.5, device=dev)
    constant = float((inv == inv[0:1]).all(axis=0).mean())
    if abs(constant - 0.5) > 2.0 / n_sites**0.5:  # Binomial(L, 0.5) / L, +/- 4 sd
        raise AssertionError(f"invariant share {constant} with p_invariant 0.5")
    found["wide"] = dict(
        command=" ".join(SIM_WIDE_ARGS), path=timings["path"], depth_levels=timings["levels"],
        wall_s=wall, simulate_s=timings["simulate"], peak_memory_bytes=peak,
        kernel_launches=counts, profile=profile, composition=observed.tolist(),
        frequencies=freqs.tolist(), zero_length_copies=True,
        invariant_constant_share=constant)
    emit("simulate_wide", **found["wide"])

    # The host walk (below 2^22 cells): card and CPU write the same bytes.
    texts, walls = {}, {}
    for device in ("cuda", "cpu"):
        path = os.path.join(workdir, f"sim_host_{device}.fasta")
        timings = {}
        _, walls[device] = timed_cli(torch, SIM_HOST_ARGS + ["--output", path, "--device",
                                                             device], timings=timings)
        if timings["path"] != "host":
            raise AssertionError(f"simulate 512 x 2048 on {device}: {timings}")
        with open(path) as fh:
            texts[device] = fh.read()
    if texts["cuda"] != texts["cpu"]:
        raise AssertionError("simulate 512 x 2048: card and CPU FASTA differ")
    found["host"] = dict(command=" ".join(SIM_HOST_ARGS), path="host", wall_s=walls["cuda"],
                         cpu_wall_s=walls["cpu"], same_fasta_as_cpu=True)
    emit("simulate_host", **found["host"])
    return found


def dnds_routes(torch, dev, workdir: str, reset_counts, launch_counts, timer) -> dict:
    """``simulate --model gy94`` (64 taxa x 1000 codons), ``dnds`` at its
    defaults (walls by part, launches, a profiled window of
    DNDS_PROFILED_STEPS Adam steps; omega and kappa beside the truth) and
    ``dnds --model gy94+g --search``; K3/K4's runtime-Q
    kernel held against its plain version at Q = 61 on the fitted tree's
    NNI neighbourhood (one shared P at length 0.1; a P per branch at the
    fitted lengths), on a 512-taxon batch (its plan, and forced into the
    global-slot mode) and at Q = 5; the ML NNI climb at Q = 61 on the
    card against the CPU. Returns what the kernels line reads."""
    from trex_tpu_torch.alignment import compress_alignment
    from trex_tpu_torch.cli._common import _load_alignment
    from trex_tpu_torch.io import load_newick, nni_neighbors_host
    from trex_tpu_torch.models import codon as cd
    from trex_tpu_torch.ops.likelihood import gtr_generator
    from trex_tpu_torch.search.ml import ml_hill_climb

    found: dict = {"launches": {}}
    fasta = os.path.join(workdir, "codons.fasta")
    _, sim_wall = timed_cli(torch, DNDS_SIM_ARGS + ["--output", fasta])
    fitted_tree = os.path.join(workdir, "codons_fit.nwk")

    def route(argv):
        reset_counts()
        timings: dict = {}
        out, wall = timed_cli(torch, argv, timings=timings)
        return out, wall, timings, launch_counts()

    out, wall, parts, launches = route(["dnds", "--alignment", fasta, "--output-tree",
                                        fitted_tree])
    if launches["k2"] <= 0 or launches["k34"] != 0:
        raise AssertionError(f"dnds: the stepwise start skipped K2, or K3/K4 ran: {launches}")
    off = {k: abs(out[k] - DNDS_TRUTH[k]) for k in DNDS_TRUTH}
    if any(off[k] > DNDS_TOLERANCE[k] for k in off):
        raise AssertionError(f"dnds: kappa {out['kappa']}, omega {out['omega']} against the "
                             f"truth {DNDS_TRUTH}")
    found["launches"]["dnds"] = launches
    found["dnds"] = dict(command="dnds (defaults: stepwise start, f3x4, gy94, 600 steps)",
                         simulate_s=sim_wall, wall_s=wall, start_s=parts["start"],
                         fit_s=parts["fits"][0], kappa=out["kappa"], omega=out["omega"],
                         truth=DNDS_TRUTH, off_truth=off, log_likelihood=out["log_likelihood"],
                         unique_codon_patterns=out["unique_codon_patterns"], launches=launches)

    # The fitted tree, the alignment's rows in its leaf order.
    names, masks, _ = _load_alignment(fasta, "dna")
    ints = np.full(masks.shape, -1, dtype=np.int32)
    for b in range(4):
        ints[masks == (1 << b)] = b
    codons = cd.encode_codons(ints)
    freqs = cd.f3x4_frequencies(ints)
    with open(fitted_tree) as fh:
        topo, blens, tree_names = load_newick(fh.read(), dev)
    rows = [names.index(n) for n in tree_names]
    patterns, counts = compress_alignment(codons[rows])
    leaves = torch.as_tensor(patterns.astype(np.int32), device=dev)
    weights = torch.as_tensor(counts.astype(np.float32), device=dev)
    prior = torch.as_tensor(freqs, device=dev)

    # Where an Adam step's time goes: DNDS_PROFILED_STEPS steps profiled,
    # against the same steps' unprofiled wall.
    def window():
        cd.optimize_gy94(topo, leaves, freqs=freqs, n_iterations=DNDS_PROFILED_STEPS,
                         site_weights=weights)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    window()
    torch.cuda.synchronize()
    profile = profile_phase(torch, window, time.perf_counter() - t0)
    found["dnds"].update(window_steps=DNDS_PROFILED_STEPS, profile=profile,
                         launches_per_step=profile["device_launches"] / DNDS_PROFILED_STEPS,
                         ms_per_step=1e3 * profile["unprofiled_wall_s"] / DNDS_PROFILED_STEPS)
    emit("dnds", **found["dnds"])

    argv = ["dnds", "--alignment", fasta, "--model", "gy94+g", "--search", "--iterations",
            str(DNDS_SEARCH_STEPS)]
    out, wall, parts, launches = route(argv)
    if launches["k2"] <= 0 or not np.isfinite(out["log_likelihood"]):
        raise AssertionError(f"dnds --search: {out}, {launches}")
    found["launches"]["dnds_search"] = launches
    found["dnds_search"] = dict(
        command=" ".join(argv[:1] + argv[3:]), wall_s=wall, start_s=parts["start"],
        fits_s=parts["fits"],
        search_s=parts["search"], tree_source=out["tree_source"], kappa=out["kappa"],
        omega=out["omega"], gamma_shape=out["gamma_shape"],
        log_likelihood=out["log_likelihood"], launches=launches)
    emit("dnds_search", **found["dnds_search"])

    # K3 and K4 at Q = 61 on the fitted tree's NNI neighbourhood: the
    # fitted GY94 model, one P at the ranking length 0.1, then a P per
    # branch at the fitted lengths (the same lengths in every tree).
    gen = cd.gy94_generator(out["kappa"], out["omega"], prior)
    nbrs = torch.as_tensor(nni_neighbors_host(topo)[0], device=dev)
    shared = torch.linalg.matrix_exp(gen * 0.1).contiguous()
    lengths = torch.as_tensor(np.nan_to_num(np.asarray(blens, np.float32)), device=dev)
    per_branch = torch.linalg.matrix_exp(gen * lengths[:, None, None])
    per_branch = per_branch[None].expand(nbrs.shape[0], -1, -1, -1).contiguous()
    at = {"dnds_shared": k34_any_q(torch, dev, nbrs, leaves, weights, prior, shared, timer),
          "dnds_per_branch": k34_any_q(torch, dev, nbrs, leaves, weights, prior, per_branch,
                                       timer)}
    del per_branch
    rng = np.random.default_rng(SEED + 60)
    n, length, batch = K34_Q61_WIDE.values()
    wide_children = torch.as_tensor(random_trees(rng, n, batch), device=dev)
    wide_leaves = torch.as_tensor(rng.integers(0, 61, (n, length)).astype(np.int32), device=dev)
    ones = torch.ones((length,), device=dev)
    for key, forced in (("wide_512", False), ("wide_512_global", True)):
        at[key] = k34_any_q(torch, dev, wide_children, wide_leaves, ones, prior, shared, timer,
                            force_global=forced)
    if at["wide_512_global"]["plan"]["mode"] != "global":
        raise AssertionError(f"K3 at 512 taxa, Q = 61: {at['wide_512_global']['plan']}")
    n, length, batch = K34_Q5.values()
    rates = rng.gamma(2.0, 1.0, (5, 5))
    prior5 = torch.as_tensor(rng.dirichlet(np.full(5, 5.0)).astype(np.float32), device=dev)
    p5 = torch.linalg.matrix_exp(gtr_generator(torch.as_tensor((rates + rates.T) / 2,
                                                               device=dev), prior5) * 0.1)
    states5 = rng.integers(0, 5, (n, length)).astype(np.int32)
    states5[rng.random(states5.shape) < 0.05] = -1
    at["q5"] = k34_any_q(torch, dev, torch.as_tensor(random_trees(rng, n, batch), device=dev),
                         torch.as_tensor(states5, device=dev), torch.ones((length,), device=dev),
                         prior5, p5.contiguous(), timer)
    for q, masks, per_branch in K34_SMALL_Q:
        key = f"q{q}" + ("_masks" if masks else "") + ("_per_branch" if per_branch else "")
        at[key] = k34_any_q(torch, dev, *small_q_inputs(torch, dev, rng, q, masks, per_branch),
                            timer, masks=masks)
    for key, row in at.items():
        emit("k34_runtime_q", shape=key, **row)
    found["k34"] = at

    # The ML NNI climb at Q = 61 under the fitted model from the fitted
    # tree: K3 ranks its batches on the card; the CPU's plain version must
    # give the same tree and score.
    s_matrix = cd.gy94_exchangeabilities(out["kappa"], out["omega"])
    climbs = {}
    for key, device in (("card", dev), ("cpu", torch.device("cpu"))):
        reset_counts()
        t0 = time.perf_counter()
        result, _, _ = ml_hill_climb(topo.to(device), leaves.to(device), 61,
                                     neighborhood="nni", max_rounds=CODON_CLIMB_ROUNDS,
                                     optimize_final_lengths=False,
                                     site_weights=weights.to(device),
                                     rates=s_matrix.to(device), freqs=prior.to(device),
                                     device=device)
        if device.type == "cuda":
            torch.cuda.synchronize()
        climbs[key] = (result, time.perf_counter() - t0, launch_counts())
    card, cpu = climbs["card"][0], climbs["cpu"][0]
    # Where card and CPU part, if they do: the ranking P (each device's) or
    # the kernel: the card's final tree scored by K3 under each device's P,
    # and by the plain version under the CPU's.
    from trex_tpu_torch.ops.likelihood import fixed_length_model
    from trex_tpu_torch.ops.likelihood_cuda import (
        batched_log_likelihood_cuda,
        batched_log_likelihood_plain,
    )

    p_card, _ = fixed_length_model(61, 0.1, s_matrix, prior, dev)
    p_cpu, _ = fixed_length_model(61, 0.1, s_matrix.cpu(), prior.cpu(), "cpu")
    tree = card.topology.children[None].contiguous()
    scored = {
        "k3_card_p": -float(batched_log_likelihood_cuda(tree, leaves, weights, prior,
                                                        p_card.contiguous())[0]),
        "k3_cpu_p": -float(batched_log_likelihood_cuda(tree, leaves, weights, prior,
                                                       p_cpu.to(dev).contiguous())[0]),
        "plain_cpu_p": -float(batched_log_likelihood_plain(
            tree.cpu(), leaves.cpu(), weights.cpu(), prior.cpu(), p_cpu)[0]),
        "p_max_abs_diff": float((p_card.cpu() - p_cpu).abs().max()),
    }
    if (not torch.equal(card.topology.children.cpu(), cpu.topology.children)
            or abs(card.score - cpu.score) > K34_RTOL * abs(cpu.score)
            or climbs["card"][2]["k34_shared"] <= 0):
        raise AssertionError(f"Q = 61 NNI climb: card {card.score} ({climbs['card'][2]}), "
                             f"cpu {cpu.score}, rescored {scored}")
    found["launches"]["codon_nni_climb"] = climbs["card"][2]
    found["codon_climb"] = dict(
        call=f"ml_hill_climb(fitted tree, codon patterns, 61, neighborhood='nni', "
             f"max_rounds={CODON_CLIMB_ROUNDS}, rates=GY94, freqs=F3x4)",
        score=card.score, cpu_score=cpu.score, rounds=card.rounds, same_tree_as_cpu=True,
        rel_diff=abs(card.score - cpu.score) / abs(cpu.score), rescored=scored,
        wall_s=climbs["card"][1], cpu_wall_s=climbs["cpu"][1], launches=climbs["card"][2])
    emit("codon_nni_climb", **found["codon_climb"])
    return found


def models_reference(torch, workdir: str) -> list[dict]:
    """Slice 6 on the card against the CPU at MODELS_REF: ``simulate``
    (JC, GTR+G+I with ancestors, GY94) byte for byte, and ``dnds --tree``
    at MODELS_REF iterations: kappa and omega within 1e-3, the
    log-likelihood within rtol K34_RTOL."""
    n, sites, steps = MODELS_REF.values()
    rows = []
    texts = {}
    for label, extra in (("jc", []), ("gtr+g+i", ["--model", "gtr+g+i"]),
                         ("gy94", ["--model", "gy94", "--kappa", "2.5", "--omega", "0.4"])):
        for device in ("cuda", "cpu"):
            paths = [os.path.join(workdir, f"ref_{label}_{device}.{k}") for k in ("fa", "nwk")]
            anc = ([] if label == "gy94" else
                   ["--output-ancestors", os.path.join(workdir, f"ref_{label}_{device}.anc")])
            run_cli(["simulate", "--leaves", str(n), "--sites", str(sites), "--seed", "4", *extra,
                     "--output", paths[0], "--output-tree", paths[1], *anc, "--device", device])
            texts[device] = [open(p).read() for p in paths + anc[1:]]
        if texts["cuda"] != texts["cpu"]:
            raise AssertionError(f"simulate {label}: card and CPU outputs differ")
        rows.append(dict(command=f"simulate {label}", n_taxa=n, sites=sites,
                         same_bytes_as_cpu=True))
    fasta, tree = (os.path.join(workdir, f"ref_gy94_cpu.{k}") for k in ("fa", "nwk"))
    fits = {device: run_cli(["dnds", "--alignment", fasta, "--tree", tree, "--iterations",
                             str(steps), "--device", device]) for device in ("cuda", "cpu")}
    card, cpu = fits["cuda"], fits["cpu"]
    if (any(abs(card[k] - cpu[k]) > 1e-3 for k in ("kappa", "omega"))
            or abs(card["log_likelihood"] - cpu["log_likelihood"])
            > K34_RTOL * abs(cpu["log_likelihood"])):
        raise AssertionError(f"dnds --tree: card {card} != cpu {cpu}")
    rows.append(dict(command=f"dnds --tree --iterations {steps}", n_taxa=n, codons=sites,
                     kappa=card["kappa"], omega=card["omega"],
                     log_likelihood=card["log_likelihood"],
                     cpu_log_likelihood=cpu["log_likelihood"]))
    return rows


def models_fields(models: dict) -> dict:
    """The K3/K4 entry's fields from the dnds phase: its grids on the codon
    routes and the runtime-Q kernel at its batches."""
    if not models:
        return {}
    return {"codon_route_launches": {
                route: {k: v[k] for k in ("k34", "k34_shared", "k34_per_branch", "k2")}
                for route, v in models["launches"].items()},
            "at_runtime_q": models["k34"]}


def models_entry(models: dict) -> dict | None:
    """K3/K4's kernels-line entry from the dnds phase alone (a run of a
    subset of the phases): the runtime-Q kernel held and timed at the
    dnds neighbourhood under one P, launches on the Q = 61 NNI climb."""
    if not models:
        return None
    first = models["k34"]["dnds_shared"]
    return {
        "name": "likelihood_batched", "route": "cuda",
        "source": "trex_tpu_torch/csrc/likelihood_batched.cu",
        "replaces": ["trex_tpu/ops/likelihood_pallas.py:255",
                     "trex_tpu/ops/likelihood_pallas.py:135"],
        "launches": models["launches"]["codon_nni_climb"]["k34"],
        **{k: first[k] for k in ("max_abs_err", "max_rel_err", "ms", "plain_ms", "bound_ms",
                                 "bound_by", "device_ms")},
        "library_ms": None, **models_fields(models),
    }


# Slice 7a (multi-device): the ('tree', 'site') mesh. The host has one
# card, and NCCL puts one rank on a card, so the mesh runs three ways: (a) a
# 1 x 1 mesh in this process (no process group), (b) a one-rank NCCL world,
# (c) two gloo ranks sharing the card (gloo runs its collectives on CUDA
# tensors), the one way the kernels see true tree and site shards here.
MESH_WORLD_TIMEOUT = 300  # the two-rank world's wall limit, seconds
MESH_PER_SITE_TREES = 64  # (b)'s per-site rows: the first trees of the NNI batch
MESH_ML_SCAN_ROUNDS = 1  # (b)'s ML scan: one reduced round at 128 x 1024
# aLRT statistics of a mesh route against its single-device run: twice a
# difference of two fitted likelihoods near 4.5e5 at 512 x 2048, where the
# batched Newton fit's float32 sums follow its chunks, which differ per
# rank. Read 0.126 apart at (2, 1) on an H100 in two runs; the bound leaves
# about 8 times that.
MESH_ALRT_TOL = 1.0
HERE = os.path.dirname(os.path.abspath(__file__))


def mesh_commands(fasta: str, device: str = "cuda") -> dict[str, list[str]]:
    """(c)'s commands by name: the default infer on each two-rank mesh, the
    ML support route (K4 on site shards) and the supports route (candidate
    fits over 'tree')."""
    tail = ["--device", device]
    return {
        "parsimony 2,1": ["infer", "--alignment", fasta, "--mesh", "2,1", *tail],
        "parsimony 1,2": ["infer", "--alignment", fasta, "--mesh", "1,2", *tail],
        "ml bootstrap 1,2": ["infer", "--alignment", fasta, *ML_SUPPORT_ARGS, "--mesh", "1,2",
                             *tail],
        "supports 2,1": ["infer", "--alignment", fasta, *SUPPORT_ARGS_4A, "--mesh", "2,1",
                         *tail],
    }


def launch_counters():
    """(wrappers, reset, read): the kernel wrappers by name, a function that
    sets every launch count to 0 and one that reads them (each wrapper's
    grids, and K3/K4's by mode: "k34_shared" (one P, K3), "k34_per_branch"
    (a P a branch, K4) and of those the per-site calls' "k34_per_site")."""
    from trex_tpu_torch.ops.fitch_cuda import batched_fitch_score_cuda
    from trex_tpu_torch.ops.fitch_levels import fitch_levels_balanced
    from trex_tpu_torch.ops.insertion_cuda import insertion_delta_cuda
    from trex_tpu_torch.ops.likelihood_cuda import batched_log_likelihood_cuda
    from trex_tpu_torch.ops.sankoff_cuda import batched_sankoff_score_cuda
    from trex_tpu_torch.ops.tree_plan import tree_plan

    wrappers = {
        "k1": batched_fitch_score_cuda, "k2": insertion_delta_cuda,
        "k34": batched_log_likelihood_cuda, "k5": batched_sankoff_score_cuda,
        "k6": fitch_levels_balanced, "plan": tree_plan,
    }

    def reset() -> None:
        for fn in wrappers.values():
            fn.launches = 0
            if hasattr(fn, "calls"):
                fn.calls = 0
        batched_log_likelihood_cuda.launches_by_mode = {"shared": 0, "per_branch": 0,
                                                         "per_site": 0}

    def read() -> dict:
        modes = batched_log_likelihood_cuda.launches_by_mode
        return {**{name: fn.launches for name, fn in wrappers.items()},
                "k34_shared": modes["shared"], "k34_per_branch": modes["per_branch"],
                "k34_per_site": modes.get("per_site", 0)}

    return wrappers, reset, read


def main_patterns(torch, fasta: str, device):
    """(patterns, weights) of an alignment as device tensors (int32 masks,
    float32 counts), as ``infer`` compresses it."""
    from trex_tpu_torch.alignment import compress_alignment
    from trex_tpu_torch.cli._common import _load_alignment

    _, masks, _ = _load_alignment(fasta, "dna")
    patterns, counts = compress_alignment(masks)
    return (torch.as_tensor(np.asarray(patterns, np.int32), device=device),
            torch.as_tensor(np.asarray(counts, np.float32), device=device))


def profiled_window(torch, fn) -> dict:
    """``fn()`` once more after a first call, profiled: this process's
    device busy time and idle share, launches, top kernels (the card's
    work of this process only)."""
    fn()
    events, wall = device_events(torch, fn)
    busy = sum(seconds for _, seconds in events.values())
    return {"wall_s": wall, "device_busy_s": busy, "idle_share": 1.0 - busy / wall,
            "device_launches": sum(count for count, _ in events.values()),
            "top": top_events(events, 4)}


def scan_round(mesh, topology, leaves, weights):
    """One sharded SPR-scan round (``sharded_spr_scan_best``) at a tree: the
    main path's climb round, the window (a) profiles."""
    from trex_tpu_torch.parallel.sharded import sharded_spr_scan_best

    return lambda: sharded_spr_scan_best(mesh, topology, leaves, weights,
                                         sequences_are_masks=True)


def score_round(torch, mesh, batch, blens, leaves, weights):
    """One round of candidate scoring over the mesh: K1 parsimony scores and
    K4 JC log-likelihoods of ``batch`` (``tile_batch``), each a psum over
    'site' and a gather over 'tree'; the window (b) and (c) profile."""
    from trex_tpu_torch.parallel import sharded as sh
    from trex_tpu_torch.types import CostModel

    hamming = CostModel.hamming(4, device=leaves.device).matrix
    kw = dict(site_weights=weights, sequences_are_masks=True)
    return lambda: (sh.sharded_batch_scores(mesh, batch, hamming, leaves, **kw),
                    sh.sharded_log_likelihoods(mesh, batch, blens, leaves, 4, **kw))


def tile_batch(torch, topology, leaves):
    """The NNI neighbourhood of ``topology`` on ``leaves``' device, and its
    JC ranking lengths (RANKING_LENGTH on every branch)."""
    from trex_tpu_torch.io import nni_neighbors_host
    from trex_tpu_torch.topology import Topology

    children, parents = nni_neighbors_host(topology)
    batch = Topology(torch.as_tensor(children, device=leaves.device),
                     torch.as_tensor(parents, device=leaves.device))
    return batch, torch.full((batch.children.shape[0], topology.n_all), RANKING_LENGTH,
                             device=leaves.device)


def shard_tiles(torch, topology, leaves, weights, reset, read) -> dict:
    """K1 (Hamming), K5 (TT(1, 2)) and K4 (JC, a P per branch) on this rank's
    tiles of ``topology``'s NNI batch, on the (2, 1) and (1, 2) meshes of
    the world: the gathered scores and this rank's launches, by mesh."""
    from trex_tpu_torch.parallel import make_mesh
    from trex_tpu_torch.parallel import sharded as sh
    from trex_tpu_torch.types import CostModel

    batch, blens = tile_batch(torch, topology, leaves)
    kw = dict(site_weights=weights, sequences_are_masks=True)
    out = {}
    for t, s in ((2, 1), (1, 2)):
        mesh = make_mesh(tree_parallelism=t)
        reset()
        scores = {
            "k1": sh.sharded_batch_scores(mesh, batch, CostModel.hamming(4, device=leaves.device)
                                          .matrix, leaves, **kw),
            "k5": sh.sharded_batch_scores(mesh, batch, CostModel.transition_transversion(
                1.0, 2.0, device=leaves.device).matrix, leaves, **kw),
            "k4": sh.sharded_log_likelihoods(mesh, batch, blens, leaves, 4, **kw),
        }
        if leaves.is_cuda:
            torch.cuda.synchronize()
        out[f"{t},{s}"] = dict(launches=read(),
                               **{k: v.cpu().tolist() for k, v in scores.items()})
    return out


def mesh_worker(rank: int, work: str) -> int:
    """One rank of a two-rank world (run as ``python -c "import chip_smoke;
    chip_smoke.mesh_worker(rank, dir)"``): gloo over ``file://`` in
    ``work``, on the card the ranks share (``device`` "cuda") or the CPU.
    Runs each command of ``work/spec.json`` after a barrier, every launch
    count set to 0 just before it and read just after, then ``shard_tiles``
    and on the card a profiled ``score_round`` at (2, 1) on the first
    command's tree; writes ``work/rank<rank>.json``."""
    import torch
    import torch.distributed as dist

    from trex_tpu_torch.parallel import initialize_distributed, make_mesh

    with open(os.path.join(work, "spec.json")) as fh:
        spec = json.load(fh)
    torch.backends.cuda.matmul.allow_tf32 = False
    initialize_distributed(f"file://{work}/rdv", 2, rank, spec["timeout"], backend="gloo",
                           device=spec["device"])
    cuda = spec["device"] == "cuda"
    # The two ranks share the host's cores.
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // 2))
    _, reset, read = launch_counters()
    results, first = {}, None
    for name, argv in spec["commands"].items():
        dist.barrier()
        if cuda:
            torch.cuda.synchronize()
        reset()
        t0 = time.perf_counter()
        run = run_cli(argv)
        if cuda:
            torch.cuda.synchronize()
        results[name] = dict(out=run.out, wall_s=time.perf_counter() - t0,
                             seconds=run.seconds, launches=read())
        first = first or run.result.topology
    if spec.get("profile"):
        leaves, weights = main_patterns(torch, spec["profile"], spec["device"])
        results["tiles"] = shard_tiles(torch, first, leaves, weights, reset, read)
        if cuda:
            batch, blens = tile_batch(torch, first, leaves)
            dist.barrier()
            results["profile"] = profiled_window(torch, score_round(
                torch, make_mesh(tree_parallelism=2), batch, blens, leaves, weights))
    with open(os.path.join(work, f"rank{rank}.json"), "w") as fh:
        json.dump(results, fh)
    dist.destroy_process_group()
    return 0


def run_mesh_world(workdir: str, name: str, commands: dict, device: str,
                   profile: str | None = None) -> list[dict]:
    """Each rank's results of ``mesh_worker`` on ``commands`` in a new
    two-rank world (``launch_world``)."""
    work = os.path.join(workdir, name)
    os.makedirs(work)
    with open(os.path.join(work, "spec.json"), "w") as fh:
        json.dump(dict(commands=commands, device=device, timeout=MESH_WORLD_TIMEOUT,
                       profile=profile), fh)
    return launch_world(work, "mesh_worker")


def launch_world(work: str, worker: str) -> list[dict]:
    """Each rank's ``work/rank<rank>.json`` after ``chip_smoke.<worker>(rank,
    work)`` ran in two processes: a rank that fails, or a world past
    MESH_WORLD_TIMEOUT, kills both and raises with their logs."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    procs = []
    for rank in range(2):
        log = open(os.path.join(work, f"log{rank}.txt"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, "-c",
             f"import sys, chip_smoke; sys.exit(chip_smoke.{worker}({rank}, {work!r}))"],
            cwd=HERE, env=env, stdout=log, stderr=subprocess.STDOUT), log))
    deadline = time.monotonic() + MESH_WORLD_TIMEOUT
    try:
        while (any(p.poll() is None for p, _ in procs)
               and not any(p.poll() for p, _ in procs) and time.monotonic() < deadline):
            time.sleep(0.2)
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
            log.close()
    if any(p.returncode for p, _ in procs):
        logs = "\n".join(f"--- rank {r} (rc {p.returncode}) ---\n"
                         + open(os.path.join(work, f"log{r}.txt")).read()[-6000:]
                         for r, (p, _) in enumerate(procs))
        raise AssertionError(f"two-rank world {os.path.basename(work)} failed:\n{logs}")
    results = []
    for rank in range(2):
        with open(os.path.join(work, f"rank{rank}.json")) as fh:
            results.append(json.load(fh))
    return results


def same_ml_route(card: dict, ref: dict) -> dict:
    """An ML route's JSON against its single-device run: the same keys,
    tree topology and counts, likelihoods within rtol K34_RTOL, lengths
    within 1e-3; bootstrap supports, supports and shares within SHARE_TOL;
    aLRT statistics within MESH_ALRT_TOL. Returns the worst differences."""
    card = {k: v for k, v in card.items() if k != "mesh"}
    ref = {k: v for k, v in ref.items() if k != "mesh"}
    worst = {"split_support": 0.0, "alrt_stat": 0.0}
    if "alrt" in ref:
        got, want = card.pop("alrt"), ref.pop("alrt")
        if [a is None for a in got] != [b is None for b in want]:
            raise AssertionError("aLRT statistics: the untested branches differ")
        worst["alrt_stat"] = max((abs(a - b) for a, b in zip(got, want) if b is not None),
                                 default=0.0)
        if worst["alrt_stat"] > MESH_ALRT_TOL:
            raise AssertionError(f"aLRT statistics {worst['alrt_stat']} apart "
                                 f"(bound {MESH_ALRT_TOL})")
    if "split_support" in ref:
        worst["split_support"] = max(abs(a - b) for a, b in zip(card["split_support"],
                                                                 ref["split_support"]))
        if worst["split_support"] > SHARE_TOL:
            raise AssertionError(f"split supports: {card['split_support']} != "
                                 f"{ref['split_support']}")
        card = {k: v for k, v in card.items() if k not in ("split_support",
                                                          "mean_split_support")}
        ref = {k: v for k, v in ref.items() if k not in ("split_support", "mean_split_support")}
    worst.update(close_supports(card, ref))
    return worst


def mesh_routes(torch, dev, workdir: str, main_fasta: str, nni_fasta: str, reuse: dict,
                reset_counts, launch_counts) -> dict:
    """Slice 7a at the main path's width, 512 x 2048: (a) ``infer --mesh
    auto`` in this process (a 1 x 1 mesh) against ``--mesh 1,1``; (b) a
    one-rank NCCL world running the sharded functions on the main path's
    and the supports' batches against the single-device functions; (c) two
    gloo ranks sharing the card running ``mesh_commands`` against the
    single-device runs (``reuse``: the ML support and supports routes'
    outputs when their phases ran, else run here), then K1, K5 and K4 on
    each rank's tiles at both meshes. Each with walls, launches and a
    profiled window: (a) a scan round (``scan_round``), (b) and (c) a round
    of candidate scoring (``score_round``). Returns what the kernels line
    reads."""
    import torch.distributed as dist

    from trex_tpu_torch.io import nni_neighbors_host
    from trex_tpu_torch.ops.dispatch import batched_scores_fastest
    from trex_tpu_torch.ops.fitch_cuda import batched_fitch_score_cuda
    from trex_tpu_torch.ops.likelihood import jc69_transition
    from trex_tpu_torch.ops.likelihood_asr import per_site_matrix
    from trex_tpu_torch.ops.likelihood_cuda import batched_log_likelihood_cuda
    from trex_tpu_torch.ops.likelihood_scan import likelihood_spr_scan_best_segmented
    from trex_tpu_torch.ops.spr_scan import spr_scan_best_segmented, spr_scan_segmented
    from trex_tpu_torch.parallel import initialize_distributed, make_mesh
    from trex_tpu_torch.parallel import sharded as sh
    from trex_tpu_torch.topology import Topology, random_topologies
    from trex_tpu_torch.types import CostModel

    found = {"launches": {}}
    pat_t, w_t = main_patterns(torch, main_fasta, dev)

    # (a) One process: --mesh auto is a 1 x 1 mesh without a process group.
    runs = {}
    for spec in ("1,1", "auto"):
        reset_counts()
        runs[spec] = timed_cli(torch, ["infer", "--alignment", main_fasta, "--mesh", spec])
        found["launches"][f"a {spec}"] = launch_counts()
    single, meshed = runs["1,1"][0].out, runs["auto"][0].out
    if meshed.pop("mesh") != {"tree": 1, "site": 1} or meshed != single:
        raise AssertionError(f"--mesh auto {meshed} != --mesh 1,1 {single}")
    tree = runs["1,1"][0].result.topology
    one = make_mesh()
    found["a"] = dict(wall_s={spec: wall for spec, (_, wall) in runs.items()},
                      seconds={spec: run.seconds for spec, (run, _) in runs.items()},
                      launches={spec: found["launches"][f"a {spec}"] for spec in runs},
                      parsimony_score=single["parsimony_score"],
                      search_rounds=single["search_rounds"], same_tree_and_score=True,
                      profile=profiled_window(torch, scan_round(one, tree, pat_t, w_t)))
    emit("mesh_a", command="infer --mesh auto (a 1 x 1 mesh, no process group) against "
         "--mesh 1,1, 512 x 2048", **found["a"])

    # (b) A one-rank NCCL world: real NCCL collectives around the kernels.
    t0 = time.perf_counter()
    initialize_distributed(f"file://{workdir}/nccl_rdv", 1, 0, 120, device=dev)
    try:
        mesh = make_mesh()
        if dist.get_backend() != ("nccl" if dev.type == "cuda" else "gloo") or \
                mesh.groups["site"] is None:
            raise AssertionError(f"the NCCL world did not form: {dist.get_backend()}")
        children, parents = nni_neighbors_host(tree)
        batch = Topology(torch.as_tensor(children, device=dev),
                         torch.as_tensor(parents, device=dev))
        hamming = CostModel.hamming(4, device=dev).matrix
        tt = CostModel.transition_transversion(1.0, 2.0, device=dev).matrix
        blens = torch.full((batch.children.shape[0], tree.n_all), RANKING_LENGTH, device=dev)
        few = Topology(batch.children[:MESH_PER_SITE_TREES], batch.parents[:MESH_PER_SITE_TREES])
        ml_leaves, ml_w = main_patterns(torch, nni_fasta, dev)
        ml_tree = random_topologies(SEED + 70, ml_leaves.shape[0], 1, dev)
        ml_tree = Topology(ml_tree.children[0], ml_tree.parents[0])
        kw = dict(site_weights=w_t, sequences_are_masks=True)
        reset_counts()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        got = {
            "k1 batch": sh.sharded_batch_scores(mesh, batch, hamming, pat_t, **kw),
            "k5 batch": sh.sharded_batch_scores(mesh, batch, tt, pat_t, **kw),
            "best tree": sh.sharded_best_tree(mesh, batch, hamming, pat_t, **kw),
            "k4 lnl": sh.sharded_log_likelihoods(mesh, batch, blens, pat_t, 4, **kw),
            "per-site rows": sh.sharded_per_site_matrix(mesh, few, pat_t, 4, weights=w_t,
                                                        sequences_are_masks=True),
            "scan table": sh.sharded_spr_scan(mesh, tree, pat_t, w_t, sequences_are_masks=True),
            "scan best": sh.sharded_spr_scan_best(mesh, tree, pat_t, w_t,
                                                  sequences_are_masks=True),
            "ml scan best": sh.sharded_spr_scan_best(mesh, ml_tree, ml_leaves, ml_w,
                                                     sequences_are_masks=True, criterion="ml",
                                                     n_states=4),
        }
        torch.cuda.synchronize()
        sharded_s = time.perf_counter() - t1
        found["launches"]["b"] = launch_counts()
        prior = torch.full((4,), 0.25, device=dev)
        p = jc69_transition(blens, 4).contiguous()
        want = {
            "k1 batch": batched_scores_fastest(batch, hamming, pat_t, w_t,
                                               sequences_are_masks=True),
            "k5 batch": batched_scores_fastest(batch, tt, pat_t, w_t, sequences_are_masks=True),
            "k4 lnl": batched_log_likelihood_cuda(batch.children, pat_t, w_t, prior, p,
                                                  sequences_are_masks=True),
            "per-site rows": per_site_matrix(few, pat_t, 4, weights=w_t,
                                             sequences_are_masks=True),
            "scan table": spr_scan_segmented(tree, pat_t, w_t, sequences_are_masks=True),
            "scan best": spr_scan_best_segmented(tree, pat_t, w_t, sequences_are_masks=True),
            "ml scan best": likelihood_spr_scan_best_segmented(
                ml_tree, ml_leaves, 4, RANKING_LENGTH, ml_w, sequences_are_masks=True),
        }
        scores = want["k1 batch"]
        want["best tree"] = (torch.argmin(scores), scores.min())
        checks = {}
        for key in got:
            a, b = got[key], want[key]
            if key in ("k4 lnl", "per-site rows"):
                rel = float(((a - b).abs() / b.abs()).max())
                if rel > K34_RTOL:
                    raise AssertionError(f"(b) {key}: rel err {rel}")
                checks[key] = {"equal": bool(torch.equal(a, b)), "max_rel_err": rel}
            elif key == "scan table":
                if not (torch.equal(a[0], b[0]) and float(a[1]) == float(b[1])):
                    raise AssertionError(f"(b) {key} differs")
                checks[key] = {"equal": True}
            elif isinstance(a, tuple) and not torch.is_tensor(a[0]):
                if a != b:
                    raise AssertionError(f"(b) {key}: {a} != {b}")
                checks[key] = {"equal": True, "move": list(a)}
            else:
                a = [float(x) for x in a] if isinstance(a, tuple) else a
                b = [float(x) for x in b] if isinstance(b, tuple) else b
                same = a == b if isinstance(a, list) else bool(torch.equal(a, b))
                if not same:
                    raise AssertionError(f"(b) {key} differs")
                checks[key] = {"equal": True}
        # K1 held and timed at the rank's tile (here the whole NNI batch).
        kids = batch.children.to(torch.int32).contiguous()
        found["k1_at_b"] = measure(
            torch, lambda: batched_fitch_score_cuda(kids, pat_t, w_t, n_states=4),
            lambda: k1_plain_in_slices(torch, kids, pat_t, w_t),
            *k1_work(kids.shape[0], pat_t.shape[0], int((w_t != 0).sum()), 4),
            ops_per_s=INT32_OPS_PER_S, plain_reps=2)
        found["b"] = dict(batch=int(batch.children.shape[0]), per_site_trees=MESH_PER_SITE_TREES,
                          ml_scan_shape=[int(ml_leaves.shape[0]), int(ml_leaves.shape[1])],
                          checks=checks, sharded_calls_s=sharded_s, k1_at_tile=found["k1_at_b"],
                          launches=found["launches"]["b"],
                          profile=profiled_window(torch, score_round(torch, mesh, batch, blens,
                                                                     pat_t, w_t)))
        if min(found["b"]["launches"][k] for k in ("k1", "k5", "k34_per_branch",
                                                   "k34_per_site")) <= 0:
            raise AssertionError(f"(b) launches: {found['b']['launches']}")
        emit("mesh_b", what="a one-rank NCCL world: the sharded functions on the main path's "
             "NNI batch (1020 trees, 512 x 2048), its tree's scans, the first "
             f"{MESH_PER_SITE_TREES} trees' per-site rows and an ML scan round at 128 x 1024, "
             "each against the single-device function", **found["b"])
        del batch, few, got, want, blens, p, kids
    finally:
        dist.destroy_process_group()
    found["b"]["wall_s"] = time.perf_counter() - t0

    # (c) Two gloo ranks on the card, against the single-device runs.
    refs = {"parsimony 2,1": runs["1,1"], "parsimony 1,2": runs["1,1"]}
    commands = mesh_commands(main_fasta)
    for name, key in (("ml bootstrap 1,2", "ml_support_out"), ("supports 2,1", "route_out")):
        if key in reuse:
            refs[name] = reuse[key]
        else:
            argv = [a for a in commands[name] if a not in ("--mesh", "1,2", "2,1")]
            refs[name] = timed_cli(torch, argv)
    # The ranks need the card's memory that this process's allocator caches.
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = run_mesh_world(workdir, "mesh_c", commands, "cuda", profile=main_fasta)
    world_s = time.perf_counter() - t0
    rows, failed = {}, []
    for name, argv in commands.items():
        ref_out, ref_wall = refs[name][0].out, refs[name][1]
        outs = [r[name]["out"] for r in ranks]
        spec = argv[argv.index("--mesh") + 1]
        got = dict(outs[0])
        try:
            if outs[0] != outs[1]:
                raise AssertionError("the ranks' results differ")
            if got.pop("mesh") != {"tree": int(spec[0]), "site": int(spec[2])}:
                raise AssertionError(f"mesh {outs[0]['mesh']}")
            if name.startswith("parsimony"):
                if got != ref_out:
                    raise AssertionError(f"{got} != single device {ref_out}")
                worst = {"equal": True}
            else:
                worst = same_ml_route(got, ref_out)
        except AssertionError as err:
            failed.append(f"(c) {name}: {str(err)[:2000]}")
            worst = {"failed": True}
        rows[name] = dict(wall_s=[r[name]["wall_s"] for r in ranks],
                          single_device_wall_s=ref_wall,
                          single_device_seconds=refs[name][0].seconds,
                          launches=[r[name]["launches"] for r in ranks],
                          seconds=[r[name]["seconds"] for r in ranks], worst=worst)
        emit("mesh_c", command=" ".join(argv[3:]) + " (512 x 2048; two gloo ranks sharing "
             "one card: not a scaling figure)", **rows[name])
    if failed:
        raise AssertionError("\n".join(failed))
    # K1, K5 and K4 on true tree and site shards, against the single-device
    # kernels on the same batch (the first route's tree: the main path's).
    batch, blens = tile_batch(torch, tree, pat_t)
    hamming = CostModel.hamming(4, device=dev).matrix
    tt = CostModel.transition_transversion(1.0, 2.0, device=dev).matrix
    single = {
        "k1": batched_scores_fastest(batch, hamming, pat_t, w_t, sequences_are_masks=True),
        "k5": batched_scores_fastest(batch, tt, pat_t, w_t, sequences_are_masks=True),
        "k4": batched_log_likelihood_cuda(
            batch.children, pat_t, w_t, torch.full((4,), 0.25, device=dev),
            jc69_transition(blens, 4).contiguous(), sequences_are_masks=True),
    }
    tiles = {}
    for shape in ("2,1", "1,2"):
        row = {"launches": [r["tiles"][shape]["launches"] for r in ranks]}
        for key, want in single.items():
            got = [torch.tensor(r["tiles"][shape][key], device=dev) for r in ranks]
            if not torch.equal(got[0], got[1]):
                raise AssertionError(f"(c) {key} at {shape}: the ranks differ")
            rel = float(((got[0] - want).abs() / want.abs()).max())
            if (key != "k4" and not torch.equal(got[0], want)) or rel > K34_RTOL:
                raise AssertionError(f"(c) {key} at {shape} differs from one device: {rel}")
            row[key] = {"equal": bool(torch.equal(got[0], want)), "max_rel_err": rel}
        for key, launch in (("k1", "k1"), ("k5", "k5"), ("k4", "k34_per_branch")):
            if min(n[launch] for n in row["launches"]) <= 0:
                raise AssertionError(f"(c) {key} at {shape} did not launch on every rank")
        tiles[shape] = row
    del batch, blens, single
    emit("mesh_c_tiles", what="K1, K5 (TT(1, 2)) and K4 (JC, a P per branch) on each rank's "
         "tile of the main path's NNI batch at (2, 1) and (1, 2), against one device",
         **tiles)
    found["c"] = dict(routes=rows, world_s=world_s, tiles=tiles,
                      profile=[r["profile"] for r in ranks])
    found["launches"]["c"] = {name: row["launches"] for name, row in rows.items()}
    found["launches"]["c tiles"] = {shape: row["launches"] for shape, row in tiles.items()}
    for key in ("k1", "k34_per_branch", "k34_per_site"):
        if not any(row["launches"][rank][key] > 0 for row in rows.values() for rank in (0, 1)):
            raise AssertionError(f"(c) no {key} launch on a shard")
    emit("mesh_c_profile", what="one round of K1 scores and K4 lnL over the (2, 1) mesh on "
         "the main path's NNI batch, profiled in each rank (its own process's kernels)",
         world_s=world_s,
         profile=found["c"]["profile"])
    return found


def mesh_reference(torch, workdir: str, devices=("cuda", "cpu")) -> list[dict]:
    """Slice 7a on the card against the CPU at REF_SHAPE: (a) ``infer --mesh
    auto``; (b) the sharded functions in a one-rank world (NCCL on the
    card, gloo on the CPU) on the NNI batch of that tree and its scans;
    (c) ``mesh_commands`` in one two-rank world, each command on the card
    and on the CPU."""
    import torch.distributed as dist

    from trex_tpu_torch.io import nni_neighbors_host
    from trex_tpu_torch.parallel import initialize_distributed, make_mesh
    from trex_tpu_torch.parallel import sharded as sh
    from trex_tpu_torch.topology import Topology
    from trex_tpu_torch.types import CostModel

    fasta = os.path.join(workdir, "mesh_ref.fasta")
    simulate_fasta(fasta, REF_SHAPE["n_taxa"], REF_SHAPE["n_sites"], SEED + 71)
    rows = []
    card_dev, cpu_dev = devices
    outs = [run_cli(["infer", "--alignment", fasta, "--mesh", "auto", "--device", d])
            for d in devices]
    if outs[0].out != outs[1].out:
        raise AssertionError(f"(a) card {outs[0].out} != cpu {outs[1].out}")
    rows.append(dict(route="(a) infer --mesh auto", parsimony_score=outs[0].out[
        "parsimony_score"], same_json=True))
    tree = outs[1].result.topology
    got = []
    for i, device in enumerate(devices):
        initialize_distributed(f"file://{workdir}/ref_rdv_{i}", 1, 0, 120, device=device)
        try:
            mesh = make_mesh()
            leaves, weights = main_patterns(torch, fasta, device)
            children, parents = nni_neighbors_host(tree)
            batch = Topology(torch.as_tensor(children, device=device),
                             torch.as_tensor(parents, device=device))
            t = tree.to(device)
            kw = dict(site_weights=weights, sequences_are_masks=True)
            got.append([
                sh.sharded_batch_scores(mesh, batch, CostModel.hamming(4, device=device).matrix,
                                        leaves, **kw).cpu(),
                sh.sharded_batch_scores(
                    mesh, batch, CostModel.transition_transversion(1.0, 2.0, device=device).matrix,
                    leaves, **kw).cpu(),
                sh.sharded_log_likelihoods(mesh, batch, torch.full(
                    (batch.children.shape[0], t.n_all), RANKING_LENGTH, device=device), leaves,
                    4, **kw).cpu(),
                sh.sharded_spr_scan(mesh, t, leaves, weights, sequences_are_masks=True)[0].cpu(),
                sh.sharded_spr_scan_best(mesh, t, leaves, weights, sequences_are_masks=True),
            ])
        finally:
            dist.destroy_process_group()
    card, cpu = got
    rel = float(((card[2] - cpu[2]).abs() / cpu[2].abs()).max())
    if not (torch.equal(card[0], cpu[0]) and torch.equal(card[1], cpu[1])
            and torch.equal(card[3], cpu[3]) and card[4] == cpu[4] and rel <= K34_RTOL):
        raise AssertionError(f"(b) card and CPU differ (lnl rel {rel})")
    rows.append(dict(route="(b) sharded functions, one-rank worlds (NCCL / gloo)",
                     batch=int(card[0].shape[0]), parsimony_equal=True, lnl_max_rel_err=rel,
                     scan_best=list(card[4])))
    commands = {f"{name} {i}": argv for i, d in enumerate(devices)
                for name, argv in mesh_commands(fasta, d).items()}
    torch.cuda.empty_cache()
    ranks = run_mesh_world(workdir, "mesh_ref", commands, card_dev)
    for name in mesh_commands(fasta):
        a, b = (ranks[0][f"{name} {i}"]["out"] for i in range(2))
        if name.startswith("parsimony"):
            if a != b:
                raise AssertionError(f"(c) {name}: card {a} != cpu {b}")
            worst = {"equal": True}
        else:
            worst = same_ml_route(a, b)
        rows.append(dict(route=f"(c) {name}, two ranks", worst=worst))
    return rows


def mesh_entry(mesh: dict) -> dict | None:
    """K1's kernels-line entry from the mesh phase alone (a run of a subset
    of the phases): launches on (c)'s default infer at (2, 1), and K1 held
    and timed at (b)'s batch, the rank's tile of the main path's NNI batch."""
    if not mesh:
        return None
    at = mesh["k1_at_b"]
    return {
        "name": "fitch_batched", "route": "cuda",
        "source": "trex_tpu_torch/csrc/fitch_batched.cu",
        "replaces": "trex_tpu/ops/sankoff_pallas.py:183",
        "launches": mesh["launches"]["c"]["parsimony 2,1"][0]["k1"],
        **{k: at[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")},
        "library_ms": None, "mesh_route_launches": mesh["launches"],
    }


# Slice 7b (the samplers over the mesh): ``mcmc``, ``bayesfactor`` and
# ``mcmc_date`` with their chains or rungs over the mesh's 'tree' axis, at
# the bayes phase's 64 x 2048 alignment: (a) the three samplers in a
# one-rank NCCL world against this process on one device; (b) two gloo
# ranks sharing the card (not a scaling figure) against the single-device
# card runs of the same command and seed.
MESH_BAYES_GENERATIONS = 500  # the mcmc and mcmc_date runs of (b)
MESH_BAYESFACTOR_GENERATIONS = 300
MESH_BAYES_ONE_RANK_GENERATIONS = 60  # (a)'s runs
MESH_BAYES_CHAINS = ["--proposal", "informed", "--informed-power", "0.1", "--branch-moves", "2"]
MESH_COLLECTIVE_REPS = 20


def mesh_bayes_jobs(fasta: str, tree_path: str, work: str, device: str = "cuda") -> dict:
    """(b)'s jobs by name: the commands (``argv``, rank 0 writing the samples
    to ``samples``) and the dating run (``date``); each also runs on one
    device in this process."""
    gens = ["--generations", str(MESH_BAYES_GENERATIONS)]
    jobs = {}
    for name, chains in (("mcmc 1x8 (2,1)", ["--runs", "1", "--chains", "8"]),
                         ("mcmc 2x4 (2,1)", ["--runs", "2", "--chains", "4"])):
        jobs[name] = dict(argv=["mcmc", "--fasta", fasta, *chains, *MESH_BAYES_CHAINS, *gens,
                                "--device", device],
                          samples=os.path.join(work, name.split()[1] + ".samples"),
                          generations=MESH_BAYES_GENERATIONS, mesh="2,1", device=device)
    jobs["bayesfactor jc,gtr 32 rungs (2,1)"] = dict(
        argv=["bayesfactor", "--fasta", fasta, "--tree", tree_path, "--models", "jc,gtr",
              "--rungs", "32", "--generations", str(MESH_BAYESFACTOR_GENERATIONS), "--device",
              device], generations=MESH_BAYESFACTOR_GENERATIONS, mesh="2,1", device=device)
    jobs["mcmc_date 8 chains strict (2,1)"] = dict(
        date=dict(fasta=fasta, tree=tree_path), generations=MESH_BAYES_GENERATIONS, mesh="2,1",
        device=device)
    return jobs


def mesh_date_run(torch, job: dict, mesh, timings: dict) -> dict:
    """``mcmc_date`` strict at 8 chains on the date job's alignment and
    tree, from the tree's true ages (no start fit): its arrays."""
    from trex_tpu_torch.io import load_newick
    from trex_tpu_torch.search import dating

    topo, lengths, _ = load_newick(open(job["date"]["tree"]).read())
    leaves, weights = main_patterns(torch, job["date"]["fasta"], job["device"])
    res = dating.mcmc_date(topo.to(job["device"]), leaves, 4, seed=SEED, n_chains=8,
                           n_generations=job["generations"],
                           start_ages=true_ages(topo, lengths), site_weights=weights,
                           sequences_are_masks=True, device=job["device"], mesh=mesh,
                           timings=timings)
    return dict(sample_ages=res.sample_ages, sample_lnl=res.sample_lnl,
                acceptance=np.array(list(res.acceptance.values())))


def run_bayes_job(torch, job: dict, mesh_spec: str | None, reset, read) -> dict:
    """One job of ``mesh_bayes_jobs`` in this process (on the mesh of
    ``mesh_spec``, or one device), every launch count set to 0 just before
    it and read just after: its output, walls, launches and the sampler's
    seconds."""
    from trex_tpu_torch.parallel import make_mesh

    cuda = job["device"] == "cuda"
    timings: dict = {}
    if cuda:
        torch.cuda.synchronize()
    reset()
    t0 = time.perf_counter()
    if "argv" in job:
        argv = list(job["argv"]) + (["--mesh", mesh_spec] if mesh_spec else [])
        if "samples" in job:
            argv += ["--samples-out", job["samples"] + ("" if mesh_spec else ".one")]
        out = run_cli(argv, timings=timings)
        arrays = {}
    else:
        mesh = make_mesh(tree_parallelism=int(mesh_spec[0])) if mesh_spec else None
        arrays = mesh_date_run(torch, job, mesh, timings)
        out = {"acceptance": arrays["acceptance"].tolist()}
    if cuda:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read()
    sampler_s = (sum(v["sampler"] for v in timings.values()) if "models" in out
                 else timings["sampler"])
    gens = job["generations"] * (2 if "models" in out else 1)
    return dict(out=out, arrays=arrays, wall_s=wall, sampler_s=sampler_s,
                generations_per_s=gens / sampler_s, ms_per_generation=1e3 * sampler_s / gens,
                launches=launches, k4_grids_per_generation=launches["k34"] / gens)


def mesh_collectives(torch, mesh, device) -> dict:
    """Walls of the samplers' collectives on ``mesh`` at the 64-taxon
    chains' sizes, each the median of MESH_COLLECTIVE_REPS after a
    barrier: the straddling swap's gather of the state (4 rows a rank),
    a Dirichlet move's gather of 16 rungs' concentrations, the counters'
    sum."""
    import torch.distributed as dist

    from trex_tpu_torch.parallel.chains import gather_packed, gather_rows, psum_counts

    n_taxa, rows = BAYES_SHAPE["n_taxa"], 4
    state = [torch.zeros((rows, n_taxa - 1, 2), dtype=torch.int32, device=device),
             torch.rand((rows, 2 * n_taxa - 1), device=device), torch.rand((rows,), device=device),
             torch.rand((rows, 1), device=device), torch.rand((rows, 1), device=device)]
    alpha = torch.rand((16, 6), device=device)
    acc = torch.zeros((4,), dtype=torch.int64, device=device)
    calls = {"swap state gather": lambda: gather_packed(mesh, state),
             "dirichlet alpha gather": lambda: gather_rows(mesh, alpha),
             "counter psum": lambda: psum_counts(mesh, acc)}
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    out = {}
    for name, fn in calls.items():
        walls = []
        dist.barrier()
        for _ in range(MESH_COLLECTIVE_REPS + 2):
            sync()
            t0 = time.perf_counter()
            fn()
            sync()
            walls.append(time.perf_counter() - t0)
        out[name] = {"ms": 1e3 * float(np.median(walls[2:]))}
    return out


def mesh_bayes_worker(rank: int, work: str) -> int:
    """One rank of (b)'s two-rank world (run as ``python -c "import
    chip_smoke; chip_smoke.mesh_bayes_worker(rank, dir)"``): gloo over
    ``file://`` in ``work``, on the card the ranks share. Runs each job of
    ``work/spec.json`` on its mesh after a barrier (``run_bayes_job``),
    then times the samplers' collectives; writes ``work/rank<rank>.json``
    and the date job's arrays to ``work/<job>_rank<rank>.npz``."""
    import torch
    import torch.distributed as dist

    from trex_tpu_torch.parallel import initialize_distributed, make_mesh

    with open(os.path.join(work, "spec.json")) as fh:
        spec = json.load(fh)
    torch.backends.cuda.matmul.allow_tf32 = False
    initialize_distributed(f"file://{work}/rdv", 2, rank, spec["timeout"], backend="gloo",
                           device=spec["device"])
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // 2))
    _, reset, read = launch_counters()
    results = {}
    for i, (name, job) in enumerate(spec["jobs"].items()):
        dist.barrier()
        row = run_bayes_job(torch, job, job["mesh"], reset, read)
        if row["arrays"]:
            np.savez(os.path.join(work, f"job{i}_rank{rank}.npz"), **row["arrays"])
        results[name] = {k: v for k, v in row.items() if k != "arrays"}
    results["collectives"] = mesh_collectives(torch, make_mesh(tree_parallelism=2),
                                              spec["device"])
    with open(os.path.join(work, f"rank{rank}.json"), "w") as fh:
        json.dump(results, fh)
    dist.destroy_process_group()
    return 0


def run_bayes_world(workdir: str, jobs: dict, device: str) -> list[dict]:
    """Each rank's results of ``mesh_bayes_worker`` on ``jobs`` in a new
    two-rank world (``launch_world``)."""
    work = os.path.join(workdir, "mesh_bayes")
    os.makedirs(work, exist_ok=True)
    with open(os.path.join(work, "spec.json"), "w") as fh:
        json.dump(dict(jobs=jobs, device=device, timeout=MESH_WORLD_TIMEOUT), fh)
    return launch_world(work, "mesh_bayes_worker")


def same_bayes_job(name: str, job: dict, meshed: dict, single: dict, arrays, one_arrays) -> dict:
    """A meshed job against its single-device run, exactly: the same JSON
    (accept rates, consensus, splits, lnL summaries), the same samples file
    and the same dating arrays (ages, lnL, acceptance). Raises where any
    differs; returns what was compared."""
    compared = ["json"]
    if meshed["out"] != single["out"]:
        raise AssertionError(f"(b) {name}: the meshed JSON differs from one device: "
                             f"{meshed['out']} != {single['out']}")
    if "samples" in job:
        with open(job["samples"]) as a, open(job["samples"] + ".one") as b:
            if a.read() != b.read():
                raise AssertionError(f"(b) {name}: the samples file differs from one device")
        compared.append("samples file")
    for key, want in one_arrays.items():
        if not np.array_equal(arrays[key], want):
            raise AssertionError(f"(b) {name}: {key} differs from one device")
        compared.append(key)
    return {"equal_to_one_device": compared}


def mesh_bayes_routes(torch, dev, workdir: str, reset_counts, launch_counts, timer) -> dict:
    """Slice 7b at 64 x 2048 (``mesh_bayes_jobs``): (a) ``mcmc_sample``
    (informed, 2 x 4 chains), ``mcmc_date`` (8 chains) and
    ``stepping_stone`` (32 rungs, GTR simplices sampled) with
    ``mesh=make_mesh()`` in a one-rank NCCL world, each bit for bit its
    call on one device; (b) the jobs on two gloo ranks sharing the card
    against their single-device card runs, each rank's gen/s, K4 grids a
    generation and the collectives' walls; K4 held and timed at a rank's
    4-chain batch. Returns what the kernels line reads."""
    import torch.distributed as dist

    from trex_tpu_torch.alignment import compress_alignment
    from trex_tpu_torch.cli._common import _load_alignment
    from trex_tpu_torch.io import load_newick, sample_topologies
    from trex_tpu_torch.ops.likelihood import jc69_transition
    from trex_tpu_torch.parallel import initialize_distributed, make_mesh
    from trex_tpu_torch.search import dating, mcmc
    from trex_tpu_torch.search.marginal import stepping_stone

    found: dict = {"launches": {}}
    fasta = os.path.join(workdir, "mesh_bayes.fasta")
    tree_path = os.path.join(workdir, "mesh_bayes.nwk")
    simulate_ultrametric(fasta, tree_path, BAYES_SHAPE["n_taxa"], BAYES_SHAPE["n_sites"],
                         SEED + 31)
    _, masks, _ = _load_alignment(fasta, "dna")
    patterns, counts = compress_alignment(masks)
    pat_t = torch.as_tensor(patterns.astype(np.int32), device=dev)
    w_t = torch.as_tensor(counts.astype(np.float32), device=dev)
    topo, lengths, _ = load_newick(open(tree_path).read())
    true_topo, ages = topo.to(dev), true_ages(topo, lengths)

    # (a) A one-rank NCCL world: each sampler with mesh=make_mesh() against
    # mesh=None, from the same seed.
    gens = MESH_BAYES_ONE_RANK_GENERATIONS
    kw = dict(seed=SEED + 2, site_weights=w_t, sequences_are_masks=True, device=dev)
    samplers = {
        "mcmc_sample 2x4 informed": lambda mesh: mcmc.mcmc_sample(
            pat_t, 4, n_generations=gens, n_runs=2, n_chains=4, topo_proposal="informed",
            topo_informed_power=0.1, branch_moves_per_gen=2, sample_every=10, mesh=mesh, **kw),
        "mcmc_date 8 chains strict": lambda mesh: dating.mcmc_date(
            true_topo, pat_t, 4, n_generations=gens, n_chains=8, start_ages=ages, mesh=mesh,
            **kw),
        "stepping_stone 32 rungs gtr": lambda mesh: stepping_stone(
            true_topo, pat_t, 4, n_rungs=32, n_generations=gens // 2, sample_model=True,
            mesh=mesh, **kw),
    }

    def arrays(res) -> dict:
        if isinstance(res, dict):
            return {k: np.asarray(res[k]) for k in ("log_ratios", "acceptance")}
        keys = [k for k in ("sample_children", "sample_lengths", "sample_ages", "sample_lnl")
                if hasattr(res, k)]
        return dict({k: getattr(res, k) for k in keys},
                    acceptance=np.array(list(res.acceptance.values())))

    one = {name: arrays(run(None)) for name, run in samplers.items()}
    t0 = time.perf_counter()
    initialize_distributed(f"file://{workdir}/mesh_bayes_nccl_rdv", 1, 0, 120, device=dev)
    try:
        mesh = make_mesh()
        if dist.get_backend() != ("nccl" if dev.type == "cuda" else "gloo") or \
                mesh.groups["tree"] is None:
            raise AssertionError(f"the NCCL world did not form: {dist.get_backend()}")
        checks = {}
        for name, run in samplers.items():
            reset_counts()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            got = arrays(run(mesh))
            torch.cuda.synchronize()
            checks[name] = dict(wall_s=time.perf_counter() - t1, launches=launch_counts())
            for key, want in one[name].items():
                if not np.array_equal(got[key], want):
                    raise AssertionError(f"(a) {name}: {key} differs from one device")
            checks[name]["bit_identical"] = True
    finally:
        dist.destroy_process_group()
    found["a"] = dict(generations=gens, checks=checks, wall_s=time.perf_counter() - t0)
    found["launches"]["a"] = {name: c["launches"] for name, c in checks.items()}
    emit("mesh_bayes_a", what="the three samplers with mesh=make_mesh() in a one-rank NCCL "
         "world against mesh=None, 64 x 2048", **found["a"])

    # (b) Two gloo ranks sharing the card, against the single-device runs.
    work = os.path.join(workdir, "mesh_bayes")
    os.makedirs(work, exist_ok=True)
    jobs = mesh_bayes_jobs(fasta, tree_path, work, dev.type)
    single = {name: run_bayes_job(torch, job, None, reset_counts, launch_counts)
              for name, job in jobs.items()}
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = run_bayes_world(workdir, jobs, dev.type)
    world_s = time.perf_counter() - t0
    rows = {}
    for i, (name, job) in enumerate(jobs.items()):
        meshed = [r[name] for r in ranks]
        if meshed[1]["out"] != meshed[0]["out"]:
            raise AssertionError(f"(b) {name}: the ranks' results differ")
        rank_arrays = ({} if not single[name]["arrays"] else
                       dict(np.load(os.path.join(work, f"job{i}_rank0.npz"))))
        rows[name] = dict(
            same_bayes_job(name, job, meshed[0], single[name], rank_arrays,
                           single[name]["arrays"]),
            single_device={k: single[name][k] for k in (
                "wall_s", "sampler_s", "generations_per_s", "ms_per_generation",
                "k4_grids_per_generation", "launches")},
            ranks=[{k: m[k] for k in ("wall_s", "sampler_s", "generations_per_s",
                                      "ms_per_generation", "k4_grids_per_generation",
                                      "launches")} for m in meshed])
        found["launches"][name] = [m["launches"] for m in meshed]
        emit("mesh_bayes_b", job=name, **({"command": " ".join(job["argv"][3:])}
                                           if "argv" in job else {}),
             note="two gloo ranks sharing one card: not a scaling figure", **rows[name])
    for name in rows:
        if min(launches["k34_per_branch"] for launches in found["launches"][name]) <= 0:
            raise AssertionError(f"(b) {name}: K4 did not launch on every rank")
    found["b"] = dict(jobs=rows, world_s=world_s,
                      collectives=[r["collectives"] for r in ranks])
    emit("mesh_bayes_collectives", what="each rank's collectives of the samplers at (2, 1), "
         "gloo on the shared card", world_s=world_s, collectives=found["b"]["collectives"])

    # K4 held and timed at a rank's 4-chain batch of the 2 x 4 sampler.
    rng = np.random.default_rng(SEED + 37)
    starts = sample_topologies(int(rng.integers(2**31)), BAYES_SHAPE["n_taxa"], 4,
                               device=dev).children
    rank_lengths = torch.as_tensor(rng.exponential(0.1, (4, 2 * BAYES_SHAPE["n_taxa"] - 1))
                                   .astype(np.float32), device=dev)
    found["k4"] = k4_bayes_at(torch, dev, starts, pat_t, w_t, torch.full((4,), 0.25, device=dev),
                              jc69_transition(rank_lengths, 4).contiguous(), timer)
    emit("mesh_bayes_k4", what="K4 at a rank's 4-chain batch (64 x 2048)", **found["k4"])
    return found


def mesh_bayes_entry(mesh_bayes: dict) -> dict | None:
    """K3/K4's kernels-line entry from the mesh_bayes phase alone (a run of
    a subset of the phases): launches on (b)'s 2 x 4 mcmc at (2, 1), rank
    0, and K4 held and timed at a rank's 4-chain batch."""
    if not mesh_bayes:
        return None
    at = mesh_bayes["k4"]
    return {
        "name": "likelihood_batched", "route": "cuda",
        "source": "trex_tpu_torch/csrc/likelihood_batched.cu",
        "replaces": "trex_tpu/ops/likelihood_pallas.py:135",
        "launches": mesh_bayes["launches"]["mcmc 2x4 (2,1)"][0]["k34"],
        **{k: at[k] for k in ("max_abs_err", "max_rel_err", "ms", "plain_ms", "bound_ms",
                              "bound_by", "device_ms")},
        "library_ms": None, "mesh_bayes_route_launches": mesh_bayes["launches"],
    }


def main(argv: list[str] | None = None) -> int:
    import torch

    phases = parse_phases(sys.argv[1:] if argv is None else argv)

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
    from trex_tpu_torch.ops.fitch_cuda import run_plan as run_k1_plan
    from trex_tpu_torch.ops.fitch_cuda import scratch_words as k1_scratch_words
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
    wrappers, reset_counts, launch_counts = launch_counters()

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
    if "native" in phases:
        # 2b. The native move library (host code, built with g++ from the
        # port's copy): loaded, or the run fails; each generator against Python.
        emit("native", **native_phase())

    workdir = tempfile.mkdtemp(prefix="trex_chip_smoke_")
    # The alignments shared by several phases (simulated in seconds).
    main_fasta = os.path.join(workdir, "main.fasta")
    simulate_fasta(main_fasta, MAIN_SHAPE["n_taxa"], MAIN_SHAPE["n_sites"], SEED + 1)
    nni_fasta = os.path.join(workdir, "nni.fasta")
    simulate_fasta(nni_fasta, NNI_SHAPE["n_taxa"], NNI_SHAPE["n_sites"], SEED + 2)

    def k1_on(children, masks, weights, n_states=4, plain_reps=5) -> dict:
        plan = k1_plan(children.shape[0], masks.shape[0], masks.shape[1], n_states,
                       *device_limits(dev))
        # The bound counts the sites of nonzero weight: the others add
        # nothing to a score.
        return dict(plan=dataclasses.asdict(plan), **measure(
            torch,
            lambda: batched_fitch_score_cuda(children, masks, weights, n_states=n_states),
            lambda: k1_plain_in_slices(torch, children, masks, weights),
            *k1_work(children.shape[0], masks.shape[0], int((weights != 0).sum()), n_states),
            ops_per_s=INT32_OPS_PER_S, plain_reps=plain_reps,
        ))

    if "kernels" in phases:
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

        # 3b. Each K1 call has its own scratch: a call captured in a CUDA graph,
        # then larger calls (2048 taxa; 8192 taxa in the global mode), then the
        # graph replayed must still give the plain version's scores bit for bit.
        # And shape (b) timed with a buffer the caller keeps (the cache the
        # wrapper had before) and with the per-call buffer, in turns.
        k1_b = k1_route_inputs(torch, dev, workdir, "b")
        plain_b = batched_fitch_score_plain(*k1_b[:3])
        graph = torch.cuda.CUDAGraph()
        captured = lambda: batched_fitch_score_cuda(*k1_b[:3], n_states=4)  # noqa: E731
        captured()
        torch.cuda.synchronize()
        with torch.cuda.graph(graph):
            graph_scores = captured()
        for key in "fi":
            children, masks, weights, q = k1_inputs(torch, dev, key, np.random.default_rng(SEED + 50))
            batched_fitch_score_cuda(children, masks, weights, n_states=q)
            del children, masks, weights
        graph.replay()
        torch.cuda.synchronize()
        if not torch.equal(graph_scores, plain_b):
            raise AssertionError("K1's graph replay after larger calls differs from the plain version")
        del graph
        plan_b = k1_plan(1, k1_b[1].shape[0], k1_b[1].shape[1], 4, *device_limits(dev))
        kept = torch.empty((k1_scratch_words(plan_b, k1_b[1].shape[0], k1_b[1].shape[1]),),
                           dtype=torch.int32, device=dev)
        scratch_runs = {
            "per_call": lambda: run_k1_plan(*k1_b[:3], plan_b),
            "kept": lambda: run_k1_plan(*k1_b[:3], plan_b, scratch=kept),
        }
        scratch_ab = {name: {"ms": [], "graph_ms": []} for name in scratch_runs}
        for name in ("per_call", "kept", "kept", "per_call"):
            if not torch.equal(scratch_runs[name](), plain_b):
                raise AssertionError(f"K1 (b) with the {name} scratch differs from the plain version")
            scratch_ab[name]["ms"].append(time_ms(torch, scratch_runs[name], 30))
            scratch_ab[name]["graph_ms"].append(graph_ms(torch, scratch_runs[name]))
        emit("k1_scratch", shape="b", graph_replay_after_larger_calls_equal=True,
             plan=dataclasses.asdict(plan_b), **scratch_ab)
        del kept, k1_b, plain_b

        # 4. K2 at real stepwise insertions, shapes (a)-(d) of K2_SHAPES, and on
        # the wide tree (e), each bit for bit against its plain version, with
        # its launch plan.
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

        # 5b. Where the main path's time goes: its two calls, profiled one by
        # one. The stepwise start (4 orders, the ML route's start too) runs
        # unprofiled; one order of it is profiled (a window of 4 orders took
        # 53 s of tracing, more than the script's time allows).
        starts = [stepwise.stepwise_addition_multi(
            patterns, n_states, n_orders=4, seed=0, sequences_are_masks=True,
            site_weights=w_t, device=dev)[0]]

        def one_order():
            stepwise.stepwise_addition_multi(patterns, n_states, n_orders=1, seed=0,
                                             sequences_are_masks=True, site_weights=w_t,
                                             device=dev)

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one_order()
        torch.cuda.synchronize()
        emit("profile", part="stepwise (1 of 4 orders)",
             **profile_phase(torch, one_order, time.perf_counter() - t0))
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
                *k34_work(*shape), rtol=K34_RTOL, plain_reps=plain_reps,
            )
            return dict(plan=dataclasses.asdict(plan), **got,
                        **device_times(run(batched_log_likelihood_cuda), got["ms"]))

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
            times and its bound at the instruction rate.
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
                          *k5_work(*shape),
                          plain_reps=plain_reps, reps=reps, ops_per_s=F32_INSTR_PER_S)
            return dict(plan=dataclasses.asdict(plan), **got, **device_times(kernel, got["ms"]))

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

    if "routes" in phases:
        # 6. NNI route: candidate batches through K1.
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
        if nni.out["parsimony_score"] != NNI_ROUTE_SCORE:
            raise AssertionError(f"NNI route score {nni.out['parsimony_score']} != {NNI_ROUTE_SCORE}")
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
        if abs(ml.out["ranking_score"] - ML_NNI_ROUTE_RANKING) > 1e-6 * ML_NNI_ROUTE_RANKING:
            raise AssertionError(
                f"ML NNI route ranking score {ml.out['ranking_score']} != {ML_NNI_ROUTE_RANKING}")
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
        # 3 of the fit's 12 sweeps profiled (all 12 took 26 s of tracing),
        # against their own unprofiled wall.
        def newton_window():
            optimize_branch_lengths_newton(
                climbed[0].topology, pat_t, n_states, site_weights=w_t,
                sequences_are_masks=True, init_length=RANKING_LENGTH, n_sweeps=3)

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        newton_window()
        torch.cuda.synchronize()
        emit("profile", part="ML Newton fit (3 of 12 sweeps)",
             **profile_phase(torch, newton_window, time.perf_counter() - t0))
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
        if set(wt_rescored.values()) != {climb.score} or climb.score != WEIGHTED_ROUTE_SCORE:
            raise AssertionError(f"weighted climb score {climb.score} != {wt_rescored}, "
                                 f"{WEIGHTED_ROUTE_SCORE}")
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

    if "differentiable" in phases:
        # 6i. The differentiable core's routes at full width (infer --start diff,
        # search, asr, nk-bench, search-run), then the core on the card against
        # the CPU at a small size.
        routes = differentiable_routes(torch, dev, workdir, nni_fasta, reset_counts, launch_counts)
        emit("reference", part="differentiable core", **differentiable_reference(torch))

    if "slice_1b" in phases:
        # 6j. Slice 1b: the support route (ratchet, decay, bootstrap, outgroup)
        # and the enumerating routes at full width, the batched stepwise path
        # at 32 states; each holds its printed tree's score to K1 and K1's
        # plain version.
        slice_1b = slice_1b_routes(torch, dev, workdir, main_fasta, nni_fasta, run, nni,
                                   reset_counts, launch_counts, k1_on)

    if "reference" in phases:
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
        # Slice 1b's flags, card against CPU.
        for row in slice_1b_reference(torch, workdir, ref_fasta):
            emit("reference", part="slice 1b", **row)
    # 8. Slice 2b: fitted ML models and rate heterogeneity (the model routes,
    # the protein route, score --criterion ml, trait, ml), then slice 2b on
    # the card against the CPU.
    slice_2b = {}
    if phases & set(SLICE_2B_PHASES):
        slice_2b = slice_2b_routes(torch, dev, workdir, phases, reset_counts, launch_counts,
                                   device_times)
    if "reference_2b" in phases:
        for row in slice_2b_reference(torch, workdir):
            emit("reference", part="slice 2b", **row)
    # 9. Slice 2c: the ML support, ratchet and constrained routes, the
    # distance route, modeltest and partition, then slice 2c on the card
    # against the CPU.
    slice_2c = {}
    if "slice_2c" in phases:
        slice_2c = slice_2c_routes(torch, dev, workdir, main_fasta, nni_fasta, slice_2b,
                                   reset_counts, launch_counts, device_times)
    if "reference_2c" in phases:
        for row in slice_2c_reference(torch, workdir):
            emit("reference", part="slice 2c", **row)
    # 10. Slice 4a: the supports route, topotest, bootstrap and the tree
    # tools at full width, then slice 4a on the card against the CPU.
    supports = {}
    if "supports" in phases:
        t0 = time.perf_counter()
        supports = supports_routes(torch, dev, workdir, main_fasta, reset_counts,
                                   launch_counts, device_times)
        emit("supports", seconds=time.perf_counter() - t0)
    if "reference_supports" in phases:
        t0 = time.perf_counter()
        for row in supports_reference(torch, workdir):
            emit("reference", part="slice 4a", **row)
        emit("reference_supports", seconds=time.perf_counter() - t0)
    # 11. Slice 5 (Bayesian): mcmc, date and bayesfactor at 64 x 2048 with K4
    # at their batches, then the samplers on the card against the CPU.
    bayes = {}
    if "bayes" in phases:
        t0 = time.perf_counter()
        bayes = bayes_routes(torch, dev, workdir, reset_counts, launch_counts, device_times)
        emit("bayes", seconds=time.perf_counter() - t0)
    if "reference_bayes" in phases:
        t0 = time.perf_counter()
        for row in bayes_reference(torch, workdir):
            emit("reference", part="slice 5", **row)
        emit("reference_bayes", seconds=time.perf_counter() - t0)
    # 12. Slice 6 (models and simulation): simulate at the scale harness's
    # size and on the host walk, dnds on GY94 codons with K3/K4's runtime-Q
    # kernel at Q = 61 (and Q = 5), then slice 6 on the card against the CPU.
    if "simulate" in phases:
        t0 = time.perf_counter()
        simulate_routes(torch, dev, workdir, reset_counts, launch_counts)
        emit("simulate", seconds=time.perf_counter() - t0)
    models = {}
    if "dnds" in phases:
        t0 = time.perf_counter()
        models = dnds_routes(torch, dev, workdir, reset_counts, launch_counts, device_times)
        emit("dnds_phase", seconds=time.perf_counter() - t0)
    if "reference_models" in phases:
        t0 = time.perf_counter()
        for row in models_reference(torch, workdir):
            emit("reference", part="slice 6", **row)
        emit("reference_models", seconds=time.perf_counter() - t0)
    # 13. Slice 7a (multi-device): the mesh at 512 x 2048 three ways (a 1 x 1
    # mesh, a one-rank NCCL world, two gloo ranks sharing the card), then
    # the same routes on the card against the CPU.
    mesh = {}
    if "mesh" in phases:
        t0 = time.perf_counter()
        mesh = mesh_routes(torch, dev, workdir, main_fasta, nni_fasta,
                           {**slice_2c, **supports}, reset_counts, launch_counts)
        emit("mesh", seconds=time.perf_counter() - t0)
    if "reference_mesh" in phases:
        t0 = time.perf_counter()
        for row in mesh_reference(torch, workdir):
            emit("reference", part="slice 7a", **row)
        emit("reference_mesh", seconds=time.perf_counter() - t0)
    # 14. Slice 7b (the samplers over the mesh) at 64 x 2048: a one-rank NCCL
    # world, then two gloo ranks sharing the card, against one device.
    mesh_bayes = {}
    if "mesh_bayes" in phases:
        t0 = time.perf_counter()
        mesh_bayes = mesh_bayes_routes(torch, dev, workdir, reset_counts, launch_counts,
                                       device_times)
        emit("mesh_bayes", seconds=time.perf_counter() - t0)
    shutil.rmtree(workdir)

    k3_model = k3_model_entry(slice_2b, slice_2c)
    per_site = per_site_entry(supports)
    if not EARLIER_PHASES <= phases:
        # A subset of the phases: the kernels its phases measured.
        kernels = [k for k in (k3_model, per_site, bayes_entry(bayes), models_entry(models),
                               mesh_entry(mesh), mesh_bayes_entry(mesh_bayes)) if k]
    else:
        kernels = [
            {
                "name": "fitch_batched", "route": "cuda",
                "source": "trex_tpu_torch/csrc/fitch_batched.cu",
                "replaces": "trex_tpu/ops/sankoff_pallas.py:183",
                "launches": main_k1, "nni_route_launches": nni_k1,
                "diff_route_launches": routes["diff"]["k1_launches"],
                "support_route_launches": slice_1b["support"]["launches"]["k1"],
                "enumerating_route_launches": {
                    key: v["launches"]["k1"] for key, v in slice_1b["enumerating"].items()},
                "stepwise_batched_launches": slice_1b["stepwise_batched"]["k1_launches"],
                "ml_nni_route_launches": ml_launches["k1"],
                "weighted_route_launches": wt_counts["k1"],
                "bench_q4_launches": bench_runs[4]["launches"]["k1"],
                **({"mesh_route_launches": mesh["launches"]} if mesh else {}),
                "shape": K1_SHAPE, **k1, "library_ms": None,
                "at_main_path": k1_main, "at_nni_route": k1_nni, "scratch_at_b": scratch_ab,
                "at_support_route": slice_1b["support"]["k1_at_this_shape"],
                "at_enumerating_routes": {
                    key: v["k1_at_this_shape"] for key, v in slice_1b["enumerating"].items()},
                "at_shapes": dict(k1_shapes, b=k1_main, c=k1_nni),
            },
            {
                "name": "insertion_delta", "route": "cuda",
                "source": "trex_tpu_torch/csrc/insertion_delta.cu",
                "replaces": "trex_tpu/ops/insertion_pallas.py:84",
                "launches": main_k2, "nni_route_launches": nni_k2,
                "support_route_launches": slice_1b["support"]["launches"]["k2"],
                "enumerating_route_launches": {
                    key: v["launches"]["k2"] for key, v in slice_1b["enumerating"].items()},
                "ml_nni_route_launches": ml_launches["k2"],
                "weighted_route_launches": wt_counts["k2"],
                **({"dnds_route_launches": models["launches"]["dnds"]["k2"]} if models else {}),
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
                "model_route_launches": slice_2b.get("launches"),
                "at_model_routes": slice_2b.get("at_model_routes"),
                **slice_2c_fields(slice_2c),
                **({"at_ml_tbr": supports["k3_at_ml_tbr"]} if supports else {}),
                **bayes_fields(bayes),
                **models_fields(models),
                **({"mesh_route_launches": mesh["launches"]} if mesh else {}),
                **({"mesh_bayes_route_launches": mesh_bayes["launches"],
                    "at_mesh_bayes_rank_batch": mesh_bayes["k4"]} if mesh_bayes else {}),
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
                **({"mesh_route_launches": mesh["launches"]} if mesh else {}),
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
        if per_site:
            kernels.append(per_site)
    emit("done", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
