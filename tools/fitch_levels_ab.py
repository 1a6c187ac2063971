#!/usr/bin/env python3
"""Time the level-synchronous Fitch kernel (K6) against the batched Fitch
kernel (K1) on the balanced level-order tree, on one CUDA card: the port of
``benchmarks/fitch_levels.py``'s A/B (level scheduling against the serial
ancestor chain).

    python3 tools/fitch_levels_ab.py [--out FILE]

At ``chip_smoke.py``'s K6 shapes (a), (a1024) (the same at half the
batch), (b), (c) and (d), on the same inputs: K6 (``fitch_levels_balanced``)
and K1 (``batched_fitch_score_cuda`` on the balanced topology, B copies of
its children) are checked bit for bit against each other and against both
plain versions. Then "serial" (K1 as the production path runs it) and
"level-sync" (K6) are timed in turns (serial, level-sync, level-sync,
serial), each turn the per-call median and the back-to-back time of
``chip_smoke.py``'s timers; where K1's rows are bit-sliced (up to 8
states) "serial, one site per word" (K1 at ``n_states=32``, K6's row
layout) takes turns too, so the A/B compares scheduling, not layout. Each
one's device time per call under ``torch.profiler`` and from a CUDA graph
of 20 calls (``chip_smoke.graph_ms``) and its trees/s (per device time and
per back-to-back time) follow, K6 at each width it can take (its plan's
choice among them) and with its plan's leaf rows read from global memory
instead of staged, and K6's phase clocks: the mean over
blocks of the clock64 cycles each spends staging its leaf rows, in its
levels and in the reduction, beside the SM clock ``nvidia-smi`` reads.
Raises without a CUDA card. Prints one JSON line per shape and one object
at the end, also written to ``--out`` (``build/k6_ab/k6_ab.json`` by
default).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

REPS = 30
SHAPES = ("a", "a1024", "b", "c", "d")


def smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", type=Path, default=ROOT / "build" / "k6_ab" / "k6_ab.json")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("fitch_levels_ab: no CUDA device")
    from trex_tpu_torch._device import device_limits
    from trex_tpu_torch.ops import _nvcc
    from trex_tpu_torch.ops import fitch_cuda as k1
    from trex_tpu_torch.ops import fitch_levels as k6

    dev = torch.device("cuda")
    _nvcc.build(["fitch_batched", "fitch_levels"])
    limits = device_limits(dev)
    result = {"nvidia_smi": smi("name,power.limit"), "device": torch.cuda.get_device_name(0),
              "ptxas": {name: [ln.strip() for ln in log.splitlines() if "registers" in ln]
                        for name, log in _nvcc.BUILD_LOG.items()},
              "shapes": []}

    def timed(fn) -> dict:
        return {"ms": chip_smoke.time_ms(torch, fn, REPS),
                "ms_back_to_back": chip_smoke.back_to_back_ms(torch, fn, REPS)}

    for key in SHAPES:
        shape = chip_smoke.K6_SHAPES[key]
        n, length, batch = shape["n_leaves"], shape["n_sites"], shape["batch"]
        masks, children, ones, alphabet, used = chip_smoke.k6_inputs(torch, dev, key)
        runs = {
            "serial": lambda: k1.batched_fitch_score_cuda(children, masks, ones, n_states=alphabet),
            "level-sync": lambda: k6.fitch_levels_balanced(masks, n_leaves=n, batch=batch),
        }
        if k1.planes_for(alphabet):
            runs["serial, one site per word"] = (
                lambda: k1.batched_fitch_score_cuda(children, masks, ones, n_states=32))
        want = k6.fitch_levels_plain(masks, n, batch)
        if not torch.equal(k1.batched_fitch_score_plain(children, masks, ones), want):
            raise AssertionError(f"({key}): the two plain versions differ")
        for name, fn in runs.items():
            if not torch.equal(fn(), want):
                raise AssertionError(f"({key}): {name} differs from the plain versions")
        turns = {name: [] for name in runs}
        order = list(runs) + list(runs)[::-1]
        for name in order:
            turns[name].append(timed(runs[name]))
        device = {name: chip_smoke.device_ms(torch, fn) for name, fn in runs.items()}
        graph = {name: chip_smoke.graph_ms(torch, fn) for name, fn in runs.items()}
        plan = k6.launch_plan(batch, n, length, *limits)
        # The plan's leaf rows read from global memory instead of staged.
        unstaged = dataclasses.replace(
            plan, staged=False, shared_bytes=k6.shared_bytes(n, plan.width, plan.depth, False))
        if not torch.equal(k6.run_plan(masks, batch, unstaged), want):
            raise AssertionError(f"({key}): K6 reading its leaves from global memory differs")
        widths = {}
        for width in k6.WIDTHS:
            alt = k6.plan_for_width(batch, n, length, width, *limits)
            if alt is not None:
                if not torch.equal(k6.run_plan(masks, batch, alt), want):
                    raise AssertionError(f"({key}): K6 at width {width} differs")
                widths[width] = {"plan": dataclasses.asdict(alt), "device_ms": chip_smoke.device_ms(
                    torch, lambda alt=alt: k6.run_plan(masks, batch, alt))}
        clocks = torch.zeros((plan.blocks, 3), dtype=torch.int64, device=dev)
        k6.run_plan(masks, batch, plan, clocks)
        mean = clocks.double().mean(0).tolist()
        bound, bound_by = chip_smoke.bound_ms(
            *chip_smoke.k6_work(batch, n, length, used), chip_smoke.INT32_OPS_PER_S)
        row = {
            "shape": key, **shape, "states_used": used, "k1_alphabet": alphabet,
            "score": float(want[0]), "equal": True,
            "k6_plan": dataclasses.asdict(plan),
            "k1_plan": dataclasses.asdict(k1.launch_plan(batch, n, length, alphabet, *limits)),
            "turns": turns, "device_ms": device, "graph_ms": graph,
            "k6_global_read_device_ms": chip_smoke.device_ms(
                torch, lambda: k6.run_plan(masks, batch, unstaged)),
            "trees_per_s_device": {name: batch / (ms / 1e3) for name, ms in device.items()},
            "trees_per_s_back_to_back": {
                name: batch / (sum(t["ms_back_to_back"] for t in ts) / len(ts) / 1e3)
                for name, ts in turns.items()},
            "k6_widths": widths, "bound_ms": bound, "bound_by": bound_by,
            "k6_phase_cycles": {"staging": mean[0], "levels": mean[1], "reduction": mean[2],
                                "levels_per_round": mean[1] / plan.rounds},
            "sm_clock": smi("clocks.sm"),
        }
        print(json.dumps(row), flush=True)
        result["shapes"].append(row)
        del masks, children, want
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
