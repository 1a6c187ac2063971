#!/usr/bin/env python3
"""Time the level-synchronous Fitch kernel (K6) against an earlier source of
itself and against the batched Fitch kernel (K1) on the balanced
level-order tree, on one CUDA card: the port of
``benchmarks/fitch_levels.py``'s A/B (level scheduling against the serial
ancestor chain), in one row layout.

    python3 tools/fitch_levels_ab.py EARLIER.cu [--out FILE]

``EARLIER.cu`` is a ``fitch_levels.cu`` with the one-site-per-word C
interface ``trex_fitch_levels(leaves, scores, phase_cycles, batch,
n_leaves, length, width, depth, staged, chunks, tree_groups, rounds,
shared_bytes, stream)``, run with the current one-site-per-word plan
(``launch_plan(..., n_states=32)``, the earlier plan). It is built with the
port's ``nvcc`` flags into ``build/tree_dp_ab/``.

At ``chip_smoke.py``'s K6 shapes (a), (a1024), (b)-(f), on the same inputs,
"earlier K6", "K6" (``fitch_levels_balanced`` with the alphabet given) and
"K1, same layout" (``batched_fitch_score_cuda`` on the balanced topology,
B copies of its children, at the alphabet where K6 is bit-sliced, else at
32 states: one site per word) are held bit for bit against each other and
against both plain versions, then timed in turns (earlier, K6, K1, K1, K6,
earlier), each turn the per-call median and the back-to-back time of
``chip_smoke.py``'s timers; where K6 is bit-sliced "K1, one site per word"
takes turns too (the layout A/B). Then each one's device time per call
under ``torch.profiler`` (by kernel) and from a CUDA graph of 20 calls
(``chip_smoke.graph_ms``), K6's plan, its phase clocks (the mean over
blocks of the clock cycles each spends staging and packing its leaf rows,
in its levels, in the split's top (also the largest: the last block's
merge of the parts' roots) and in the reduction), its bound, and K6 under
the bit-sliced plans the rule chose between (node lanes, or parts of the
split). Where the rule took one site per word at a bit-sliced alphabet
(few trees), "K6, bit-sliced split" takes turns too. Then the crossover
of the two modes at few trees (``crossover``). Prints the ptxas report of
both builds, one JSON line per shape and one object at the end, also
written to ``--out`` (``build/k6_ab/k6_ab.json`` by default). Raises
without a CUDA card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from tools.tree_dp_ab import build_earlier, device_split, ptxas_lines  # noqa: E402

REPS = 30
SHAPES = ("a", "a1024", "b", "c", "d", "e", "f")


def smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def sweep_plans(k6, batch: int, n: int, plan, smem_optin: int) -> list:
    """The rule's bit-sliced plan with the node lanes it chose between (1-16
    a tree, many trees) or with 4-64 parts (the split), its depth, slots,
    rounds and shared bytes recomputed; those that fit."""
    most = k6.MAX_DEPTH_8 if plan.planes == 8 else k6.MAX_DEPTH
    alts = []
    if plan.parts == 1:
        for lanes in (1, 2, 4, 8, 16):
            slots = min(batch, k6.TREE_LANES // lanes)
            depth = k6.register_depth(n, lanes, most)
            alts.append(dataclasses.replace(
                plan, lanes=lanes, slots=slots, depth=depth,
                rounds=-(-batch // (slots * plan.tree_groups)),
                shared_bytes=k6.sliced_shared_bytes(n, plan.planes, depth, slots, 1)))
    else:
        for parts in (4, 8, 16, 32, 64):
            if parts > n // 2:
                continue
            lanes = min(k6.SPLIT_THREADS // k6.WORDS, max(1, (n // parts) >> k6.SPLIT_DEPTH))
            depth = k6.register_depth(n // parts, lanes, most)
            alts.append(dataclasses.replace(
                plan, parts=parts, lanes=lanes, depth=depth,
                shared_bytes=k6.sliced_shared_bytes(n, plan.planes, depth, 1, parts)))
    return [alt for alt in alts if alt.shared_bytes <= smem_optin]


def crossover(torch, k6, dev, limits) -> list:
    """Where the bit-sliced plan splits each tree (few trees), the split
    against one site per word (``sites_plan``) at B = 1, 2, 3, 4, 8 on
    128-4096 leaves of 1024 and 2048 sites, 4 states: both bit for bit
    against the plain version, graph ms the lower of two turns, and the
    mode ``launch_plan`` takes."""
    rows = []
    rng = np.random.default_rng(chip_smoke.SEED + 11)
    for length in (2048, 1024):
        for n in (128, 256, 512, 1024, 2048, 4096):
            masks = torch.as_tensor(chip_smoke.k1_masks(rng, n, length, 4), device=dev)
            for batch in (1, 2, 3, 4, 8):
                split = k6.sliced_plan(batch, n, length, 4, *limits)
                if split.parts == 1:
                    continue
                plans = {"split": split, "one site per word": k6.sites_plan(
                    batch, n, length, *limits)}
                want = k6.fitch_levels_plain(masks, n, batch)
                graph = {name: [] for name in plans}
                for name, plan in plans.items():
                    if not torch.equal(k6.run_plan(masks, batch, plan), want):
                        raise AssertionError(f"crossover {n} x {length}, B={batch}: {name}")
                for name in list(plans) * 2:
                    graph[name].append(chip_smoke.graph_ms(
                        torch, lambda plan=plans[name]: k6.run_plan(masks, batch, plan)))
                row = {"n_leaves": n, "n_sites": length, "batch": batch,
                       "graph_ms": {name: min(ms) for name, ms in graph.items()},
                       "plans": {name: dataclasses.asdict(plan) for name, plan in plans.items()},
                       "rule": k6.launch_plan(batch, n, length, 4, *limits).mode}
                print(json.dumps({"crossover": row}), flush=True)
                rows.append(row)
    return rows


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("earlier", type=Path)
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
    earlier_lib, earlier_ptxas = build_earlier(args.earlier, "fitch_levels", 3, 10)
    limits = device_limits(dev)
    result = {
        "nvidia_smi": smi("name,power.limit"), "device": torch.cuda.get_device_name(0),
        "ptxas": {"current": {name: ptxas_lines(log) for name, log in _nvcc.BUILD_LOG.items()},
                  "earlier": {"fitch_levels": earlier_ptxas}},
        "shapes": [],
    }
    print(json.dumps({"ptxas": result["ptxas"]}), flush=True)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    def earlier(masks, batch, plan, clocks=None):
        # The earlier wrapper's launch: its plan, scores, the C call.
        n, length = masks.shape
        scores = torch.empty((batch,), dtype=torch.float32, device=dev)
        rc = earlier_lib.trex_fitch_levels(
            masks.data_ptr(), scores.data_ptr(), None if clocks is None else clocks.data_ptr(),
            batch, n, length, plan.width, plan.depth, int(plan.staged), plan.chunks,
            plan.tree_groups, plan.rounds, plan.shared_bytes, stream())
        if rc != 0:
            raise RuntimeError(f"earlier fitch_levels launch failed: CUDA error {rc}")
        return scores

    for key in SHAPES:
        shape = chip_smoke.K6_SHAPES[key]
        n, length, batch = shape["n_leaves"], shape["n_sites"], shape["batch"]
        masks, children, ones, alphabet, used = chip_smoke.k6_inputs(torch, dev, key)
        plan = k6.launch_plan(batch, n, length, alphabet, *limits)
        earlier_plan = k6.launch_plan(batch, n, length, 32, *limits)
        same_layout = alphabet if plan.planes else 32
        runs = {
            "earlier K6": lambda: earlier(masks, batch, earlier_plan),
            "K6": lambda: k6.fitch_levels_balanced(
                masks, n_leaves=n, batch=batch, n_states=alphabet),
            "K1, same layout": lambda: k1.batched_fitch_score_cuda(
                children, masks, ones, n_states=same_layout),
        }
        if plan.planes:
            runs["K1, one site per word"] = lambda: k1.batched_fitch_score_cuda(
                children, masks, ones, n_states=32)
        # Where the rule took one site per word at a bit-sliced alphabet
        # (few trees), the bit-sliced split it chose against.
        sliced = plan if plan.planes else None
        if not plan.planes and k1.planes_for(alphabet):
            sliced = k6.sliced_plan(batch, n, length, k1.planes_for(alphabet), *limits)
            runs["K6, bit-sliced split"] = lambda: k6.run_plan(masks, batch, sliced)
        want = k6.fitch_levels_plain(masks, n, batch)
        if not torch.equal(k1.batched_fitch_score_plain(children, masks, ones), want):
            raise AssertionError(f"({key}): the two plain versions differ")
        for name, fn in runs.items():
            first, again = fn(), fn()
            if not (torch.equal(first, want) and torch.equal(again, want)):
                raise AssertionError(f"({key}): {name} differs from the plain versions")
        turns = {name: [] for name in runs}
        for name in list(runs) + list(runs)[::-1]:
            turns[name].append({"ms": chip_smoke.time_ms(torch, runs[name], REPS),
                                "ms_back_to_back": chip_smoke.back_to_back_ms(
                                    torch, runs[name], REPS)})
        profiler = {name: device_split(torch, fn) for name, fn in runs.items()}
        device = {name: sum(split.values()) for name, split in profiler.items()}
        graph = {name: chip_smoke.graph_ms(torch, fn) for name, fn in runs.items()}
        phases = {}
        for name, clocked in (("K6", plan), ("K6, bit-sliced split", sliced)):
            if clocked is None or (name != "K6" and clocked is plan):
                continue
            clocks = torch.zeros((clocked.blocks, 4), dtype=torch.int64, device=dev)
            k6.run_plan(masks, batch, clocked, clocks)
            mean = clocks.double().mean(0).tolist()
            phases[name] = {"staging": mean[0], "levels": mean[1], "top": mean[2],
                            "top_max": float(clocks[:, 2].max()), "reduction": mean[3]}
        earlier_clocks = torch.zeros((earlier_plan.blocks, 3), dtype=torch.int64, device=dev)
        earlier(masks, batch, earlier_plan, earlier_clocks)
        sweep = []
        for alt in sweep_plans(k6, batch, n, sliced, limits.smem_optin) if sliced else []:
            if not torch.equal(k6.run_plan(masks, batch, alt), want):
                raise AssertionError(f"({key}): K6 with plan {alt} differs")
            sweep.append({"plan": dataclasses.asdict(alt), "graph_ms": chip_smoke.graph_ms(
                torch, lambda alt=alt: k6.run_plan(masks, batch, alt))})
        bound, bound_by = chip_smoke.bound_ms(
            *chip_smoke.k6_work(batch, n, length, used), chip_smoke.INT32_OPS_PER_S)
        row = {
            "shape": key, **shape, "states_used": used, "k1_alphabet": alphabet,
            "k1_same_layout_states": same_layout, "score": float(want[0]), "equal": True,
            "k6_plan": dataclasses.asdict(plan), "k6_mode": plan.mode, "k6_split": plan.parts,
            "earlier_plan": dataclasses.asdict(earlier_plan),
            "k1_plan": dataclasses.asdict(k1.launch_plan(batch, n, length, same_layout, *limits)),
            "turns": turns, "device_ms": device, "profiler_by_kernel": profiler,
            "graph_ms": graph, "bound_ms": bound, "bound_by": bound_by,
            "fraction_of_bound": {name: bound / ms for name, ms in device.items()},
            "trees_per_s_device": {name: batch / (ms / 1e3) for name, ms in device.items()},
            "k6_phase_cycles": phases,
            "earlier_phase_cycles": dict(zip(
                ("staging", "levels", "reduction"), earlier_clocks.double().mean(0).tolist())),
            "k6_sweep": sweep, "sm_clock": smi("clocks.sm"),
        }
        print(json.dumps(row), flush=True)
        result["shapes"].append(row)
        del masks, children, want
    result["crossover"] = crossover(torch, k6, dev, limits)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
