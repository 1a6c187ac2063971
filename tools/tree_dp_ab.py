#!/usr/bin/env python3
"""Time the tree-DP kernels K5 (min-plus Sankoff) and K3/K4 (pruning
likelihood) against earlier versions of their sources, on one CUDA card.

    python3 tools/tree_dp_ab.py EARLIER_SANKOFF.cu EARLIER_LIKELIHOOD.cu [--out FILE]

The earlier sources are a ``sankoff_batched.cu`` and a
``likelihood_batched.cu`` with the global-scratch C interfaces
``trex_sankoff_batched(children, leaves, cost, weights, scratch,
block_sums, out, batch, n_leaves, length, n_states, masks, hamming, chunk,
stream)`` and ``trex_likelihood_batched(children, leaves, pmats, prior,
weights, scratch, block_sums, out, batch, n_leaves, length, n_states,
shared, masks, chunk, stream)`` (ancestors in index order, every row in a
global scratch). They are built with the port's ``nvcc`` flags into
``build/tree_dp_ab/`` and run as their wrappers ran them: trees in chunks
over a 2 GiB scratch, with the earlier wrappers' host work.

Shapes: ``chip_smoke.py``'s K5 (a)-(f) and K3/K4 (a)-(c), its deep shapes
(a caterpillar and a random tree of 2048 taxa x 1024 sites, B = 4, for
both kernels) and K5's global-slot shape (Q = 128 at 2048 taxa); (b) and
(c) take the NNI neighbourhood of a random tree on the weighted route's
and the main path's simulated alignments, where ``chip_smoke.py`` takes
the routes' start trees. At every shape both versions are held to the
plain version (K5 bit for bit, K3/K4 within rtol 1e-5) and to each other
(bit for bit: the same rows in another order, the same site sum), then
timed in turns (earlier, current, current, earlier), each turn the
per-call median and the back-to-back time of ``chip_smoke.py``'s timers;
then each one's device time per call under ``torch.profiler``, the
current one's split by kernel (plan pass, DP, site sum), and its launch
plan. At K5 (e) the current kernel also runs with its slots forced into
the global-slot mode, against the plan's shared slots. Prints the ptxas
report of both builds, one JSON line per shape and one object at the end,
also written to ``--out`` (``build/tree_dp_ab/tree_dp_ab.json`` by
default).
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

REPS = 30
EARLIER_SCRATCH_BYTES = 2 << 30  # the earlier wrappers' ancestor scratch per call
BUILD = ROOT / "build" / "tree_dp_ab"


def smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def ptxas_lines(log: str) -> list[str]:
    return [ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln or "Function properties" in ln]


def build_earlier(source: Path, name: str, n_ptr: int, n_int: int) -> tuple[ctypes.CDLL, list]:
    from trex_tpu_torch.ops import _nvcc

    BUILD.mkdir(parents=True, exist_ok=True)
    lib_path = BUILD / f"lib{name}_earlier.so"
    done = subprocess.run(
        [_nvcc._nvcc(), *_nvcc.NVCC_FLAGS, "-o", str(lib_path), str(source)],
        check=True, capture_output=True, text=True,
    )
    lib = ctypes.CDLL(str(lib_path))
    fn = getattr(lib, f"trex_{name}")
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, ptxas_lines(done.stdout + done.stderr)


def device_split(torch, fn, reps: int = 10) -> dict:
    """Device milliseconds per call of ``fn`` under ``torch.profiler``, by
    kernel name (first 60 characters)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key[:60]: e.self_device_time_total / 1e3 / reps
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA}


def main() -> int:
    import numpy as np
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("earlier_sankoff", type=Path)
    parser.add_argument("earlier_likelihood", type=Path)
    parser.add_argument("--out", type=Path, default=BUILD / "tree_dp_ab.json")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("tree_dp_ab: no CUDA device", file=sys.stderr)
        return 1
    from trex_tpu_torch._device import device_limits
    from trex_tpu_torch.ops import _nvcc
    from trex_tpu_torch.ops import likelihood_cuda as k34
    from trex_tpu_torch.ops import sankoff_cuda as k5
    from trex_tpu_torch.ops.likelihood import jc69_transition

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    _nvcc.build(["tree_plan", "sankoff_batched", "likelihood_batched"])
    k5_lib, k5_ptxas = build_earlier(args.earlier_sankoff, "sankoff_batched", 7, 7)
    k34_lib, k34_ptxas = build_earlier(args.earlier_likelihood, "likelihood_batched", 8, 7)
    smem_optin = device_limits(dev).smem_optin
    result = {
        "nvidia_smi": smi("name,power.limit"), "device": torch.cuda.get_device_name(0),
        "ptxas": {"current": {name: ptxas_lines(log) for name, log in _nvcc.BUILD_LOG.items()},
                  "earlier": {"sankoff_batched": k5_ptxas, "likelihood_batched": k34_ptxas}},
        "shapes": [],
    }
    print(json.dumps({"ptxas": result["ptxas"]}), flush=True)

    def earlier_k5(children, leaves, cost, weights, hamming, masks):
        # The earlier wrapper's host work: checks, contiguous inputs, the
        # chunk of trees whose rows fit the scratch, the scratch and block
        # sums, the launch.
        k5._check(children, leaves, cost, weights, masks)
        batch, n_anc, _ = children.shape
        length, q = leaves.shape[1], cost.shape[0]
        out = torch.empty((batch,), dtype=torch.float32, device=dev)
        children, leaves, cost, weights = (
            x.contiguous() for x in (children, leaves, cost, weights))
        per_tree = 4 * n_anc * q * length
        chunk = max(1, min(batch, 65535, EARLIER_SCRATCH_BYTES // per_tree))
        scratch = torch.empty((chunk * per_tree // 4,), dtype=torch.float32, device=dev)
        block_sums = torch.empty((batch, -(-length // 128)), dtype=torch.float32, device=dev)
        rc = k5_lib.trex_sankoff_batched(
            children.data_ptr(), leaves.data_ptr(), cost.data_ptr(), weights.data_ptr(),
            scratch.data_ptr(), block_sums.data_ptr(), out.data_ptr(), batch, n_anc + 1,
            length, q, int(masks), int(hamming), chunk, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"earlier K5 launch failed: CUDA error {rc}")
        return out

    def earlier_k34(children, leaves, weights, prior, transition, masks):
        k34._check(children, leaves, weights, prior, transition, masks)
        batch, n_anc, _ = children.shape
        length, q = leaves.shape[1], prior.shape[0]
        out = torch.empty((batch,), dtype=torch.float32, device=dev)
        children, leaves, weights, prior, transition = (
            x.contiguous() for x in (children, leaves, weights, prior, transition))
        per_tree = 4 * n_anc * q * length
        chunk = max(1, min(batch, 65535, EARLIER_SCRATCH_BYTES // per_tree))
        scratch = torch.empty((chunk * per_tree // 4,), dtype=torch.float32, device=dev)
        block_sums = torch.empty((batch, -(-length // 128)), dtype=torch.float32, device=dev)
        rc = k34_lib.trex_likelihood_batched(
            children.data_ptr(), leaves.data_ptr(), transition.data_ptr(), prior.data_ptr(),
            weights.data_ptr(), scratch.data_ptr(), block_sums.data_ptr(), out.data_ptr(),
            batch, n_anc + 1, length, q, int(transition.dim() == 2), int(masks), chunk,
            torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"earlier K3/K4 launch failed: CUDA error {rc}")
        return out

    def compare(kernel: str, key: str, cur, old, plain, shape: dict, plan, rtol=None) -> dict:
        want = plain()
        got, got_old = cur(), old()
        torch.cuda.synchronize()
        for name, x in (("current", got), ("earlier", got_old)):
            if rtol is None and not torch.equal(x, want):
                raise AssertionError(f"{kernel} ({key}): {name} differs from the plain version")
            if rtol is not None:
                rel = float(((x - want).abs() / want.abs()).max())
                if not rel <= rtol:
                    raise AssertionError(f"{kernel} ({key}): {name} rel err {rel} > {rtol}")
        t_one = chip_smoke.time_ms(torch, cur, 3, 1)
        reps = max(3, min(REPS, int(300 / max(t_one, 1e-3))))
        times = {"earlier": [], "current": []}
        for name, fn in (("earlier", old), ("current", cur), ("current", cur),
                         ("earlier", old)):
            times[name].append({"ms": chip_smoke.time_ms(torch, fn, reps),
                                "ms_back_to_back": chip_smoke.back_to_back_ms(torch, fn, reps)})
        split = device_split(torch, cur, min(10, reps))
        row = {"kernel": kernel, "shape": key, **shape, "plan": dataclasses.asdict(plan),
               "equal_to_earlier": bool(torch.equal(got, got_old)),
               "max_rel_err": float(((got - want).abs() / want.abs()).max()), "reps": reps,
               **times, "current_device_ms": sum(split.values()),
               "current_device_split": split,
               "earlier_device_ms": chip_smoke.device_ms(torch, old, min(10, reps)),
               "sm_clock": smi("clocks.sm")}
        return row

    rng = np.random.default_rng(chip_smoke.SEED + 20)
    tt = chip_smoke.transition_transversion_cost(torch, dev)
    workdir = BUILD / "fasta"
    workdir.mkdir(parents=True, exist_ok=True)
    routes = chip_smoke.route_batches(torch, dev, str(workdir))

    def k5_case(key, children, leaves, cost, weights, hamming=False, masks=False, **extra):
        n_leaves, length = leaves.shape
        q = cost.shape[0]
        shape = dict(n_taxa=n_leaves, n_sites=length, batch=int(children.shape[0]),
                     n_states=q, hamming=hamming, masks=masks, **extra)
        plan = k5.launch_plan(n_leaves, q, hamming, masks, smem_optin)

        def call(fn):
            return lambda: fn(children, leaves, cost, weights, hamming=hamming,
                              sequences_are_masks=masks)
        row = compare("k5", key, call(k5.batched_sankoff_score_cuda),
                      lambda: earlier_k5(children, leaves, cost, weights, hamming, masks),
                      call(k5.batched_sankoff_score_plain), shape, plan)
        if key == "e":  # the global-slot mode at the same shape, against the plan's
            forced = dataclasses.replace(
                plan, mode="global",
                smem_bytes=plan.smem_bytes - 4 * plan.slots * q * plan.sites_per_block)
            chosen = k5.launch_plan
            k5.launch_plan = lambda *a: forced
            try:
                got = call(k5.batched_sankoff_score_cuda)()
                row["forced_global"] = {
                    "plan": dataclasses.asdict(forced),
                    "equal": bool(torch.equal(got, call(k5.batched_sankoff_score_plain)())),
                    "device_ms": chip_smoke.device_ms(torch, call(k5.batched_sankoff_score_cuda)),
                }
            finally:
                k5.launch_plan = chosen
        print(json.dumps(row), flush=True)
        result["shapes"].append(row)

    def k34_case(key, children, leaves, weights, transition, masks=False, **extra):
        n_leaves, length = leaves.shape
        prior = torch.full((4,), 0.25, device=dev)
        shape = dict(n_taxa=n_leaves, n_sites=length, batch=int(children.shape[0]),
                     per_branch=transition.dim() == 4, masks=masks, **extra)
        plan = k34.launch_plan(n_leaves, 4, transition.dim() == 2, masks, smem_optin)

        def call(fn):
            return lambda: fn(children, leaves, weights, prior, transition,
                              sequences_are_masks=masks)
        row = compare("k34", key, call(k34.batched_log_likelihood_cuda),
                      lambda: earlier_k34(children, leaves, weights, prior, transition, masks),
                      call(k34.batched_log_likelihood_plain), shape, plan,
                      rtol=chip_smoke.K34_RTOL)
        print(json.dumps(row), flush=True)
        result["shapes"].append(row)

    def trees(n, batch):
        return torch.as_tensor(chip_smoke.random_trees(rng, n, batch), device=dev)

    def states(n, length, q):
        return torch.as_tensor(rng.integers(0, q, (n, length)).astype(np.int32), device=dev)

    # K5 (a)-(f), as chip_smoke.py's k5 phases.
    n, length, batch = (chip_smoke.K5_BENCH_SHAPE[k] for k in ("n_taxa", "n_sites", "batch"))
    ones = torch.ones((length,), device=dev)
    a_trees, a_states = trees(n, batch), states(n, length, 4)
    k5_case("a", a_trees, a_states, tt, ones)
    k5_case("b", routes["weighted"][0], routes["weighted"][1], tt, routes["weighted"][2])
    k5_case("c", routes["ml"][0], routes["ml"][1], tt, routes["ml"][2], masks=True)
    n, length, batch, q = chip_smoke.K5_Q20_SHAPE.values()
    k5_case("d", trees(n, batch), states(n, length, q),
            torch.as_tensor(chip_smoke.asymmetric_cost(rng, q), device=dev), ones)
    n, length, batch, q = chip_smoke.K5_Q61_SHAPE.values()
    k5_case("e", trees(n, batch), states(n, length, q),
            torch.ones((q, q), device=dev) - torch.eye(q, device=dev), ones)
    k5_case("f", a_trees, a_states, torch.ones((4, 4), device=dev) - torch.eye(4, device=dev),
            ones, hamming=True)
    del a_trees
    # The deep shapes and the global-slot shape.
    deep = chip_smoke.deep_inputs(torch, dev)
    for key, (children, leaves, weights) in deep.items():
        k5_case(key, children, leaves, tt, weights)
    glob = chip_smoke.K5_GLOBAL_SHAPE
    k5_case("global", trees(glob["n_taxa"], glob["batch"]),
            states(glob["n_taxa"], glob["n_sites"], glob["n_states"]),
            torch.as_tensor(rng.random((glob["n_states"],) * 2).astype(np.float32) * 3, device=dev),
            torch.as_tensor(rng.random(glob["n_sites"]).astype(np.float32) * 3, device=dev))
    # K3/K4 (a)-(c) and the deep shapes.
    p01 = jc69_transition(torch.tensor(chip_smoke.RANKING_LENGTH, device=dev), 4)
    n, length, batch = (chip_smoke.K34_SHAPE[k] for k in ("n_taxa", "n_sites", "batch"))
    k34_case("a", trees(n, batch), states(n, length, 4), torch.ones((length,), device=dev), p01)
    k34_case("b", routes["ml"][0], routes["ml"][1], routes["ml"][2], p01, masks=True)
    n, length, batch = (chip_smoke.K4_BRANCH_SHAPE[k] for k in ("n_taxa", "n_sites", "batch"))
    lengths = torch.as_tensor(rng.uniform(0.05, 1.0, (batch, 2 * n - 1)).astype(np.float32),
                              device=dev)
    missing = rng.integers(0, 4, (n, length)).astype(np.int32)
    missing[rng.random((n, length)) < 0.05] = -1
    k34_case("c", trees(n, batch), torch.as_tensor(missing, device=dev),
             torch.ones((length,), device=dev), jc69_transition(lengths, 4).contiguous())
    for key, (children, leaves, weights) in deep.items():
        k34_case(key, children, leaves, weights, p01)

    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
