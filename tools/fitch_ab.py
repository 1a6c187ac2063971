#!/usr/bin/env python3
"""Time the batched Fitch kernel (K1) against an earlier version of its
source, on one CUDA card, at ``chip_smoke.py``'s K1 shapes (a)-(h), and read
the current kernel's per-block phase clocks.

    python3 tools/fitch_ab.py EARLIER.cu [--parent DIR] [--out FILE]

``EARLIER.cu`` is a ``fitch_batched.cu`` with the interface
``trex_fitch_batched(children, masks, weights, scores, batch, n_leaves,
length, sites_per_block, stream)`` (one thread per site). It is built with
the port's ``nvcc`` flags into ``build/k1_ab/`` and run as its wrapper ran
it: a zeroed scores tensor per call and the widest of 128, 64, 32, 16 or 8
sites per block whose table fits the card's shared memory, with the
earlier wrapper's host work. Shapes (a) and
(d)-(h) are ``chip_smoke.py``'s own inputs; (b) and (c) take a random tree
(or the NNI neighbourhood of one) on the main path's and the NNI route's
alignments, where ``chip_smoke.py`` takes those routes' results. At every
shape both kernels are checked bit for bit against the plain version, then
timed in turns (earlier, current, current, earlier), each turn the
per-call median and the back-to-back time of ``chip_smoke.py``'s timers;
then each one's device time per call under ``torch.profiler`` and its host
time per call, enqueued without waiting.
Phase clocks: the mean over blocks of the clock64 cycles each block spends
staging, walking, expanding its counters and restaging children, beside
the SM clock ``nvidia-smi`` reads.

With ``--parent DIR`` (a checkout of the earlier commit) it also runs, as
subprocesses from DIR and from this checkout, ``bench --states 4 --reps
100`` (the earlier's, this one's twice, the earlier's) and ``infer`` on the main
path's and the NNI route's simulated alignments, and reports whether both
print the same tree and score. Prints one JSON line per measurement and
one object at the end, also written to ``--out``
(``build/k1_ab/k1_ab.json`` by default).
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

REPS = 30
EARLIER_SITES_PER_BLOCK = (128, 64, 32, 16, 8)


def smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def build_earlier(source: Path) -> ctypes.CDLL:
    from trex_tpu_torch.ops import _nvcc

    out_dir = ROOT / "build" / "k1_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / "libfitch_batched_earlier.so"
    subprocess.run(
        [_nvcc._nvcc(), *_nvcc.NVCC_FLAGS, "-o", str(lib_path), str(source)],
        check=True, capture_output=True, text=True,
    )
    lib = ctypes.CDLL(str(lib_path))
    lib.trex_fitch_batched.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.trex_fitch_batched.restype = ctypes.c_int
    return lib


def cli(checkout: Path, argv: list[str]) -> dict:
    """The JSON object the port's CLI prints, run from ``checkout``."""
    out = subprocess.run([sys.executable, "-m", "trex_tpu_torch.cli", *argv], cwd=checkout,
                         capture_output=True, text=True, check=True).stdout
    return json.loads(out.strip().splitlines()[-1])


def against_parent(parent: Path) -> dict:
    """``bench --states 4`` in turns and the two parsimony routes' results,
    from ``parent`` and from this checkout."""
    # 100 back-to-back batches a turn: at about 0.1 ms a batch, bench's own
    # 5 are shorter than the host's jitter.
    bench = ["bench", "--leaves", "64", "--sites", "1024", "--batch", "512", "--reps", "100",
             "--states", "4"]
    turns = {"earlier": [], "current": []}
    for name, where in (("earlier", parent), ("current", ROOT), ("current", ROOT),
                        ("earlier", parent)):
        turns[name].append(cli(where, bench))
    routes = {}
    workdir = Path(tempfile.mkdtemp(prefix="k1_routes_"))
    for route, shape, seed, extra in (
            ("main_path", chip_smoke.MAIN_SHAPE, chip_smoke.SEED + 1, []),
            ("nni_route", chip_smoke.NNI_SHAPE, chip_smoke.SEED + 2,
             ["--neighborhood", "nni", "--rounds", "20"])):
        fasta = workdir / f"{route}.fasta"
        chip_smoke.simulate_fasta(str(fasta), shape["n_taxa"], shape["n_sites"], seed)
        outs = {name: cli(where, ["infer", "--alignment", str(fasta), *extra])
                for name, where in (("earlier", parent), ("current", ROOT))}
        routes[route] = {"same_output": outs["earlier"] == outs["current"],
                         "parsimony_score": outs["current"]["parsimony_score"],
                         "earlier_parsimony_score": outs["earlier"]["parsimony_score"]}
    row = {"bench_q4": turns, "routes": routes}
    print(json.dumps(row), flush=True)
    return row


def host_ms(torch, fn, reps: int = 200) -> float:
    """Host milliseconds per call of ``fn`` enqueued without waiting for the
    device (the wrapper's own work and its launches)."""
    import time

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return host


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("earlier", type=Path)
    parser.add_argument("--parent", type=Path, default=None)
    parser.add_argument("--out", type=Path, default=ROOT / "build" / "k1_ab" / "k1_ab.json")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("fitch_ab: no CUDA device", file=sys.stderr)
        return 1
    import numpy as np

    from trex_tpu_torch._device import device_limits
    from trex_tpu_torch.ops import _nvcc
    from trex_tpu_torch.ops import fitch_cuda as k1

    dev = torch.device("cuda")
    _nvcc.build(["fitch_batched"])
    earlier_lib = build_earlier(args.earlier)
    n_sms, optin = device_limits(dev)
    print(json.dumps({"ptxas": [ln.strip() for ln in _nvcc.BUILD_LOG.get("fitch_batched", "").splitlines()
                                if "registers" in ln or "spill" in ln]}), flush=True)

    def earlier(children, masks, weights):
        # The earlier wrapper's host work, as it was: checks, contiguous
        # inputs, the card's shared memory read for the sites per block, a
        # zeroed scores tensor, the launch under the device's context.
        k1._check(children, masks, weights, None)
        batch, n_anc, _ = children.shape
        scores = torch.zeros((batch,), dtype=torch.float32, device=dev)
        children, masks, weights = (x.contiguous() for x in (children, masks, weights))
        smem = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
        spb = next(s for s in EARLIER_SITES_PER_BLOCK if (2 * n_anc + 1) * s * 4 <= smem)
        with torch.cuda.device(dev):
            rc = earlier_lib.trex_fitch_batched(
                children.data_ptr(), masks.data_ptr(), weights.data_ptr(), scores.data_ptr(),
                batch, n_anc + 1, masks.shape[1], spb,
                torch.cuda.current_stream(dev).cuda_stream)
        if rc:
            raise RuntimeError(f"earlier kernel launch failed: CUDA error {rc}")
        return scores

    def phase_cycles(children, masks, weights, plan) -> dict:
        clocks = torch.zeros((plan.blocks, 4), dtype=torch.int64, device=dev)
        k1.run_plan(children, masks, weights, plan, clocks)
        mean = clocks.double().mean(0).tolist()
        return {"staging": mean[0], "walk": mean[1], "expansion": mean[2],
                "children": mean[3], "walk_per_step_per_round":
                    mean[1] / max(1, plan.rounds * children.shape[1])}

    def timed(fn) -> dict:
        return {"ms": chip_smoke.time_ms(torch, fn, REPS),
                "ms_back_to_back": chip_smoke.back_to_back_ms(torch, fn, REPS)}

    def compare(key: str, children, masks, weights, n_states) -> dict:
        want = k1.batched_fitch_score_plain(children, masks, weights)
        plan = k1.launch_plan(children.shape[0], masks.shape[0], masks.shape[1], n_states,
                              n_sms, optin)
        cur = lambda: k1.batched_fitch_score_cuda(children, masks, weights, n_states=n_states)  # noqa: E731
        old = lambda: earlier(children, masks, weights)  # noqa: E731
        for name, fn in (("current", cur), ("earlier", old)):
            if not torch.equal(fn(), want):
                raise AssertionError(f"{name} kernel differs from the plain version at ({key})")
        times = {"earlier": [], "current": []}
        for name, fn in (("earlier", old), ("current", cur), ("current", cur),
                         ("earlier", old)):
            times[name].append(timed(fn))
        row = {"shape": key, "batch": int(children.shape[0]), "n_taxa": int(masks.shape[0]),
               "n_sites": int(masks.shape[1]), "n_states": n_states,
               "plan": dataclasses.asdict(plan), **times,
               "current_device_ms": chip_smoke.device_ms(torch, cur),
               "earlier_device_ms": chip_smoke.device_ms(torch, old),
               "current_host_ms": host_ms(torch, cur),
               "earlier_host_ms": host_ms(torch, old),
               "phase_cycles": phase_cycles(children, masks, weights, plan),
               "sm_clock": smi("clocks.sm")}
        print(json.dumps(row), flush=True)
        return row

    result = {"nvidia_smi": smi("name,power.limit"), "device": torch.cuda.get_device_name(0),
              "shapes": []}
    workdir = tempfile.mkdtemp(prefix="k1_ab_")
    inputs = {"a": chip_smoke.k1_inputs(torch, dev, "a", np.random.default_rng(chip_smoke.SEED))}
    for key in "bc":
        inputs[key] = chip_smoke.k1_route_inputs(torch, dev, workdir, key)
    for key in "defgh":
        inputs[key] = chip_smoke.k1_inputs(
            torch, dev, key, np.random.default_rng(chip_smoke.SEED + ord(key)))
    for key in "abcdefgh":
        result["shapes"].append(compare(key, *inputs[key]))
    if args.parent is not None:
        result["against_parent"] = against_parent(args.parent.resolve())
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
