#!/usr/bin/env python3
"""Time the insertion kernel (K2) against an earlier version of its source,
on one CUDA card, at ``chip_smoke.py``'s K2 shapes; read the current
kernel's per-block phase clocks; and time it on one site, whose launch is
the down pass's dependent chain alone.

    python3 tools/insertion_ab.py EARLIER.cu [--out FILE]

``EARLIER.cu`` is an ``insertion_delta.cu`` with the global-scratch
interface ``trex_insertion_delta(children, up, weights, down, delta,
n_leaves, length, t_node, stream)`` that reads a flagless up table. It is
built with the port's ``nvcc`` flags into ``build/k2_ab/`` and run as its
wrapper ran it: a fresh down scratch and a zeroed delta per call, on a
masked table. At every shape both are checked bit for bit against the
plain version, then timed in turns (earlier, current, current, earlier),
each turn the per-call median and the back-to-back time of
``chip_smoke.py``'s timers. Phase clocks: the mean over blocks of the
clock64 cycles each block spends staging, walking and in the delta pass,
beside the SM clock ``nvidia-smi`` reads. Prints one JSON object and
writes it to ``--out`` (``build/k2_ab/k2_ab.json`` by default).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

REPS = 30


def smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def build_earlier(source: Path) -> ctypes.CDLL:
    from trex_tpu_torch.ops import _nvcc

    out_dir = ROOT / "build" / "k2_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / "libinsertion_delta_earlier.so"
    subprocess.run(
        [_nvcc._nvcc(), *_nvcc.NVCC_FLAGS, "-o", str(lib_path), str(source)],
        check=True, capture_output=True, text=True,
    )
    lib = ctypes.CDLL(str(lib_path))
    lib.trex_insertion_delta.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    lib.trex_insertion_delta.restype = ctypes.c_int
    return lib


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("earlier", type=Path)
    parser.add_argument("--out", type=Path, default=ROOT / "build" / "k2_ab" / "k2_ab.json")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("insertion_ab: no CUDA device", file=sys.stderr)
        return 1
    from trex_tpu_torch.ops import _nvcc
    from trex_tpu_torch.ops import insertion_cuda as k2
    from trex_tpu_torch.search.stepwise import _SMASK

    dev = torch.device("cuda")
    _nvcc.build(["insertion_delta"])
    earlier_lib = build_earlier(args.earlier)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    def earlier(var, up, t, w):
        n_all, length = up.shape
        down = torch.empty_like(up)
        delta = torch.zeros((n_all,), dtype=torch.float32, device=dev)
        rc = earlier_lib.trex_insertion_delta(
            var.data_ptr(), up.data_ptr(), w.data_ptr(), down.data_ptr(),
            delta.data_ptr(), var.shape[0] + 1, length, t, stream())
        if rc:
            raise RuntimeError(f"earlier kernel launch failed: CUDA error {rc}")
        return delta

    def phase_cycles(var, up, t, w) -> dict:
        n_all, length = up.shape
        plan = k2.launch_plan(n_all, length, *k2.device_limits(dev))
        delta = torch.zeros((n_all,), dtype=torch.float32, device=dev)
        clocks = torch.zeros((plan.blocks, 3), dtype=torch.int64, device=dev)
        rc = k2._library().trex_insertion_delta(
            var.data_ptr(), up.data_ptr(), w.data_ptr(), delta.data_ptr(),
            clocks.data_ptr(), var.shape[0] + 1, length, t, plan.sites_per_block,
            int(plan.staged), plan.shared_bytes, stream())
        if rc:
            raise RuntimeError(f"kernel launch failed: CUDA error {rc}")
        mean = clocks.double().mean(0).tolist()
        return {"plan": plan.__dict__, "staging": mean[0], "walk": mean[1],
                "delta_pass": mean[2], "walk_per_step": mean[1] / max(1, var.shape[0])}

    def timed(fn) -> dict:
        return {"ms": chip_smoke.time_ms(torch, fn, REPS),
                "ms_back_to_back": chip_smoke.back_to_back_ms(torch, fn, REPS)}

    def compare(cell: dict, var, up, t, w) -> dict:
        masked = up & _SMASK
        want = k2.insertion_delta_plain(var, up, t, w)
        cur = lambda: k2.insertion_delta_cuda(var, up, t, w)  # noqa: E731
        old = lambda: earlier(var, masked, t, w)  # noqa: E731
        for name, fn in (("current", cur), ("earlier", old)):
            if not torch.equal(fn(), want):
                raise AssertionError(f"{name} kernel differs from the plain version")
        times = {"earlier": [], "current": []}
        for name, fn in (("earlier", old), ("current", cur), ("current", cur),
                         ("earlier", old)):
            times[name].append(timed(fn))
        row = dict(cell, padded_patterns=up.shape[1], **times,
                   phase_cycles=phase_cycles(var, up, t, w), sm_clock=smi("clocks.sm"))
        print(json.dumps(row), flush=True)
        return row

    result = {"nvidia_smi": smi("name,power.limit"), "device": torch.cuda.get_device_name(0),
              "shapes": [], "one_site": []}
    workdir = tempfile.mkdtemp(prefix="k2_ab_")
    groups: dict[tuple, list] = {}
    for cell in chip_smoke.K2_SHAPES:
        groups.setdefault((cell["n_taxa"], cell["n_sites"], cell["n_states"]), []).append(cell)
    for (n_taxa, n_sites, q), cells in groups.items():
        pats, cnts = chip_smoke.k2_alignment(workdir, n_taxa, n_sites, q, chip_smoke.SEED + 1)
        steps = sorted(c["insertion"] for c in cells)
        for step, (var, up, t, w) in chip_smoke.k2_insertions(pats, cnts, q, steps, dev):
            cell = next(c for c in cells if c["insertion"] == step)
            result["shapes"].append(compare(cell, var, up, t, w))
            if step == steps[-1]:
                # One site: one block walks the whole chain alone.
                one = (var, up[:, :1].contiguous(), t, w[:1].contiguous())
                result["one_site"].append({
                    "n_taxa": n_taxa, "n_states": q, "insertion": step,
                    "n_anc": int(var.shape[0]), "phase_cycles": phase_cycles(*one),
                    **timed(lambda: k2.insertion_delta_cuda(*one))})
                print(json.dumps(result["one_site"][-1]), flush=True)
    wide = chip_smoke.K2_WIDE
    result["shapes"].append(compare(wide, *chip_smoke.k2_wide_inputs(
        torch, dev, wide["n_taxa"], wide["n_sites"], chip_smoke.SEED)))
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
