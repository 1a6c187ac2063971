#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``trex_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout

Builds the three CUDA kernels from ``trex_tpu_torch/csrc`` (one ``nvcc``
per source, in parallel), holds each against its plain PyTorch version on
the card at its path's shapes (the parsimony kernels bit for bit, since
their scores are integer-valued; the likelihood kernel within rtol 1e-5 of
|lnL|), times them, then runs the ``infer`` command's routes on simulated
alignments:

- the main path, the default ``infer`` (stepwise addition, best of 4
  orders, then SPR-scan climb) on 512 taxa x 2048 sites, counting the
  launches of each kernel — the insertion kernel (K2) at every stepwise
  step, the Fitch kernel (K1) for each order's exact rescoring;
- the NNI route (``--neighborhood nni --rounds 20``) on 128 x 1024,
  whose candidate batches K1 scores;
- the ML NNI route (``--criterion ml --neighborhood nni --rounds 10``) on
  the main path's 512 x 2048 alignment, whose candidate batches the
  likelihood kernel (K3/K4) ranks, then the Newton branch-length fit;
- the default ML route (``--criterion ml``, analytic SPR scan, plain
  torch) on 128 x 1024 with ``--rounds 5``, a reduced size.

It also profiles the main path's two calls (stepwise addition, SPR-scan
climb) and the ML NNI route's two (climb, Newton fit) with
``torch.profiler`` for the device's busy and idle share and the top
kernels, and checks on a small divergent alignment that the card's
``infer`` returns the same tree and score as the CPU's, for both criteria
and both neighborhoods.

Each phase prints one JSON line. The line before the last is
``{"kernels": [...]}``; the last is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Any failure raises and exits non-zero; so does a machine without a CUDA
device, or a directory without the port beside this script.
"""

from __future__ import annotations

import contextlib
import io
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
# float32 rate outside the tensor cores (also used for 32-bit integer ALU
# work).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
K1_SHAPE = dict(n_taxa=64, n_sites=1024, batch=2048)
K34_SHAPE = dict(n_taxa=64, n_sites=1024, batch=1024)
K4_BRANCH_SHAPE = dict(n_taxa=64, n_sites=1024, batch=256)
MAIN_SHAPE = dict(n_taxa=512, n_sites=2048)
NNI_SHAPE = dict(n_taxa=128, n_sites=1024)
ML_SCAN_SHAPE = dict(n_taxa=128, n_sites=1024)
REF_SHAPE = dict(n_taxa=24, n_sites=300)
K34_RTOL = 1e-5
RANKING_LENGTH = 0.1


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def simulate_fasta(
    path: str, n_taxa: int, n_sites: int, seed: int, branch=(0.02, 0.1)
) -> None:
    """JC69 alignment down a random coalescent tree, branch lengths
    uniform in ``branch``, with about 1% of characters replaced by N or -."""
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
            missing = rng.random(n_sites) < 0.01
            row[missing] = rng.choice(np.frombuffer(b"N-", dtype=np.uint8), int(missing.sum()))
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


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def measure(
    torch, kernel, plain, n_bytes: float, n_ops: float, reps: int = 30,
    rtol: float | None = None,
) -> dict:
    """Hold ``kernel()`` against ``plain()`` — bit for bit, or within
    ``rtol`` of |plain| — and time both (``ms``: the per-call median)."""
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
    bound, bound_by = bound_ms(n_bytes, n_ops)
    return {
        "equal": bool(torch.equal(got, want)), "max_abs_err": err, "max_rel_err": rel,
        "ms": time_ms(torch, kernel, reps),
        "ms_back_to_back": back_to_back_ms(torch, kernel, reps),
        "plain_ms": time_ms(torch, plain, 5, 1),
        "bound_ms": bound, "bound_by": bound_by,
    }


def k1_work(batch: int, n_taxa: int, n_sites: int) -> tuple[float, float]:
    """K1's (bytes, int32 ops): children, leaves, weights in, scores out;
    an AND, a compare, an OR, a select and an add per set update."""
    n_bytes = 4.0 * (batch * (n_taxa - 1) * 2 + n_taxa * n_sites + n_sites + batch)
    return n_bytes, 5.0 * batch * (n_taxa - 1) * n_sites


def k34_work(batch: int, n_taxa: int, n_sites: int, q: int, per_branch: bool):
    """K3/K4's (bytes, float32 ops): children, leaves, weights, prior and P
    in, scores out; per tree, ancestor and site 2 x 2Q^2 for the two
    messages, Q for the combine, 2Q for the max and the scale."""
    p_floats = batch * (2 * n_taxa - 1) * q * q if per_branch else q * q
    n_bytes = 4.0 * (
        batch * (n_taxa - 1) * 2 + n_taxa * n_sites + n_sites + q + p_floats + batch
    )
    return n_bytes, float(batch * (n_taxa - 1) * n_sites * (4 * q * q + 3 * q))


def strip_lengths(newick: str) -> str:
    import re

    return re.sub(r":[0-9.eE+-]+", "", newick)


def run_cli(argv: list[str]):
    """The ``infer`` command in this process; returns its InferRun."""
    from trex_tpu_torch.cli import build_parser
    from trex_tpu_torch.cli.infer import run_infer

    with contextlib.redirect_stdout(io.StringIO()):
        return run_infer(build_parser().parse_args(argv))


def profile_phase(torch, fn, unprofiled_wall: float) -> dict:
    """Device-busy time and the top kernels of ``fn()`` under
    ``torch.profiler``. One stream, so the summed kernel and copy time is
    the busy time; the idle share is taken against the same call's wall
    time without the profiler (``unprofiled_wall``), since tracing
    ~10^5 launches slows the host."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
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
    from trex_tpu_torch.ops import _nvcc
    from trex_tpu_torch.ops.fitch_cuda import (
        batched_fitch_score_cuda,
        batched_fitch_score_plain,
    )
    from trex_tpu_torch.ops.insertion_cuda import (
        insertion_delta_cuda,
        insertion_delta_plain,
    )
    from trex_tpu_torch.ops.likelihood import jc69_transition
    from trex_tpu_torch.ops.likelihood_asr import optimize_branch_lengths_newton
    from trex_tpu_torch.ops.likelihood_cuda import (
        batched_log_likelihood_cuda,
        batched_log_likelihood_plain,
    )
    from trex_tpu_torch.search import stepwise
    from trex_tpu_torch.search.hillclimb import parsimony_hill_climb
    from trex_tpu_torch.search.ml import ml_hill_climb
    from trex_tpu_torch.types import CostModel

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()

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

    # 2. Build the three kernels from the checkout's sources, in parallel.
    t0 = time.perf_counter()
    _nvcc.build()
    ptxas = {
        name: [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
        for name, log in _nvcc.BUILD_LOG.items()
    }
    emit("build", seconds=time.perf_counter() - t0, ptxas=ptxas)

    workdir = tempfile.mkdtemp(prefix="trex_chip_smoke_")

    def k1_on(children, masks, weights) -> dict:
        return measure(
            torch,
            lambda: batched_fitch_score_cuda(children, masks, weights),
            lambda: batched_fitch_score_plain(children, masks, weights),
            *k1_work(children.shape[0], masks.shape[0], masks.shape[1]),
        )

    # 3. K1 at bench.py's shape: 64 taxa x 1024 sites, B = 2048 trees.
    rng = np.random.default_rng(SEED)
    n, length, batch = K1_SHAPE["n_taxa"], K1_SHAPE["n_sites"], K1_SHAPE["batch"]
    masks_np = (1 << rng.integers(0, 4, (n, length))).astype(np.int32)
    ambiguous = rng.random((n, length)) < 0.05
    masks_np[ambiguous] = rng.integers(1, 16, int(ambiguous.sum()))
    k1 = k1_on(
        torch.as_tensor(random_trees(rng, n, batch), device=dev),
        torch.as_tensor(masks_np, device=dev),
        torch.as_tensor(rng.integers(1, 6, length).astype(np.float32), device=dev),
    )
    emit("k1", shape=K1_SHAPE, trees_per_s=batch / (k1["ms"] / 1e3), **k1)

    # 4. K2 at one real stepwise insertion, 512 taxa x 2048 sites.
    main_fasta = os.path.join(workdir, "main.fasta")
    simulate_fasta(main_fasta, MAIN_SHAPE["n_taxa"], MAIN_SHAPE["n_sites"], SEED + 1)
    _, aln, n_states = _load_alignment(main_fasta, "dna")
    patterns, counts = compress_alignment(aln)
    order = [int(t) for t in np.random.default_rng(SEED).permutation(aln.shape[0])]
    st = stepwise._seed_state(
        patterns.astype(np.int32), order, (1 << n_states) - 1,
        counts.astype(np.float32), dev,
    )
    k_probe = aln.shape[0] // 2
    for k in range(3, k_probe):
        stepwise._insert(st, k)
    var, up_states, t_node = stepwise._insertion_inputs(st, k_probe)
    n_all, sites = up_states.shape
    k2 = measure(
        torch,
        lambda: insertion_delta_cuda(var, up_states, t_node, st.weights),
        lambda: insertion_delta_plain(var, up_states, t_node, st.weights),
        4.0 * (var.numel() + up_states.numel() + sites + n_all),
        # down pass: two combine0 (7 ops each) per ancestor per site; delta
        # pass: combine0, AND, compare, select, add per node per site.
        14.0 * (n_all // 2) * sites + 11.0 * n_all * sites,
    )
    emit("k2", n_taxa=aln.shape[0], n_sites=aln.shape[1], padded_patterns=sites,
         insertion_step=k_probe, **k2)
    del st, var, up_states

    # 5. Main path: the default infer on 512 x 2048, on the card. The
    # parsimony path ranks nothing by likelihood: K3/K4 must not launch.
    for fn in (batched_fitch_score_cuda, insertion_delta_cuda, batched_log_likelihood_cuda):
        fn.launches = 0
    t0 = time.perf_counter()
    run = run_cli(["infer", "--alignment", main_fasta])
    torch.cuda.synchronize()
    main_wall = time.perf_counter() - t0
    main_k1 = batched_fitch_score_cuda.launches
    main_k2 = insertion_delta_cuda.launches
    main_k34 = batched_log_likelihood_cuda.launches
    if main_k2 <= 0 or main_k1 <= 0 or main_k34 != 0:
        raise AssertionError(
            f"main path launches: K1 {main_k1}, K2 {main_k2}, K3/K4 {main_k34}")
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
         rescored=rescored,
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

    def k34_on(children, leaves, weights, transition, masks) -> dict:
        def run(fn):
            return lambda: fn(children, leaves, weights, uniform, transition,
                              sequences_are_masks=masks)
        return measure(
            torch, run(batched_log_likelihood_cuda), run(batched_log_likelihood_plain),
            *k34_work(children.shape[0], leaves.shape[0], leaves.shape[1], 4,
                      transition.dim() == 4),
            rtol=K34_RTOL,
        )

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
    del ml_batch
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

    # 6. NNI route: candidate batches through K1.
    nni_fasta = os.path.join(workdir, "nni.fasta")
    simulate_fasta(nni_fasta, NNI_SHAPE["n_taxa"], NNI_SHAPE["n_sites"], SEED + 2)
    for fn in (batched_fitch_score_cuda, insertion_delta_cuda, batched_log_likelihood_cuda):
        fn.launches = 0
    t0 = time.perf_counter()
    nni = run_cli(["infer", "--alignment", nni_fasta, "--neighborhood", "nni",
                   "--rounds", "20"])
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

    # 6b. ML NNI route on the main path's alignment: candidate batches
    # ranked by K3/K4, then the Newton fit.
    for fn in (batched_fitch_score_cuda, insertion_delta_cuda, batched_log_likelihood_cuda):
        fn.launches = 0
    t0 = time.perf_counter()
    ml = run_cli(["infer", "--alignment", main_fasta, "--criterion", "ml",
                  "--neighborhood", "nni", "--rounds", "10"])
    torch.cuda.synchronize()
    ml_wall = time.perf_counter() - t0
    ml_launches = {
        "k1": batched_fitch_score_cuda.launches, "k2": insertion_delta_cuda.launches,
        "k34": batched_log_likelihood_cuda.launches,
    }
    if ml_launches["k34"] <= 0 or ml_launches["k2"] <= 0:
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
         k34_launches=ml_launches["k34"], rescored=rescored)

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
    for fn in (batched_fitch_score_cuda, insertion_delta_cuda, batched_log_likelihood_cuda):
        fn.launches = 0
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
    shutil.rmtree(workdir)

    kernels = [
        {
            "name": "fitch_batched", "route": "cuda",
            "source": "trex_tpu_torch/csrc/fitch_batched.cu",
            "replaces": "trex_tpu/ops/sankoff_pallas.py:183",
            "launches": main_k1, "nni_route_launches": nni_k1,
            "ml_nni_route_launches": ml_launches["k1"],
            "shape": K1_SHAPE, **k1, "library_ms": None,
            "at_main_path": k1_main, "at_nni_route": k1_nni,
        },
        {
            "name": "insertion_delta", "route": "cuda",
            "source": "trex_tpu_torch/csrc/insertion_delta.cu",
            "replaces": "trex_tpu/ops/insertion_pallas.py:84",
            "launches": main_k2, "nni_route_launches": nni_k2,
            "ml_nni_route_launches": ml_launches["k2"],
            "shape": {"n_taxa": MAIN_SHAPE["n_taxa"], "padded_patterns": sites},
            **k2, "library_ms": None,
        },
        {
            "name": "likelihood_batched", "route": "cuda",
            "source": "trex_tpu_torch/csrc/likelihood_batched.cu",
            "replaces": ["trex_tpu/ops/likelihood_pallas.py:255",
                         "trex_tpu/ops/likelihood_pallas.py:135"],
            # Its path is the ML NNI route; the parsimony main path runs none.
            "launches": ml_launches["k34"], "main_path_launches": main_k34,
            "shape": K34_SHAPE, **k34, "library_ms": None,
            "at_ml_nni_route": k34_route, "per_branch": k34_branch,
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
