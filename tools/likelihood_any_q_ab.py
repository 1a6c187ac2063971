#!/usr/bin/env python3
"""K3/K4 at Q other than 4 and 20 against an earlier ``likelihood_batched.cu``
on one CUDA card.

    git show HEAD:trex_tpu_torch/csrc/likelihood_batched.cu > build/likelihood_any_q_ab/earlier.cu
    python3 tools/likelihood_any_q_ab.py build/likelihood_any_q_ab/earlier.cu [--out FILE]

The earlier source is the one whose runtime-Q kernel took every Q other
than 4 and 20 (a thread per (site, 16-state tile), two block barriers a
step), with the C interface ``trex_likelihood_batched(plan, children,
leaves, pmats, prior, weights, slots_g, per_site, out, batch, n_leaves,
length, n_states, shared, masks, n_slots, sites, global_slots, use_table,
chunk, smem, stream)``. It is built with the port's ``nvcc`` flags into
``build/likelihood_any_q_ab/`` and run as its wrapper ran it (its launch
plan, the same tree plan).

Shapes: ``chip_smoke.py``'s runtime-Q batches (a codon NNI neighbourhood,
124 trees, 64 taxa x 1000 patterns, Q = 61, a GY94 P at 0.1, then a P per
branch; 32 random 512-taxon trees x 1000 sites at Q = 61, the plan's slots
and forced to the global-slot mode; 256 trees of 64 taxa x 1024 sites at
Q = 5; its small-Q shapes, ``chip_smoke.K34_SMALL_Q``: every width class of
the fixed kernels and of the runtime-Q kernel), the 512-taxon trees with a
P per branch, Q = 21 with a P per branch, and Q = 4 and 20 (the fixed
kernels the earlier source had) at K34_Q5's size, Q = 4 on masks also at
the main path's ``chip_smoke.K34_SHAPE``. With a P per branch above 20
states the current kernel also runs in the slot mode its plan did not
take. At every shape both builds are held to the plain version (rtol 1e-5)
and to each other (rows and sums bit for bit), then timed in turns
(earlier, current, current, earlier): the per-call median and the device
ms a call of a CUDA graph. At Q = 4 and 20 the earlier fixed kernels summed
as the compiler contracted them and the current ones in an explicit chain,
so a difference there is reported (``drifted``: rows differing, their
largest distance in ulps, the sums' largest difference) and is no failure;
anywhere else it fails the shape, and the tool exits 1. Prints each
build's nvcc time and ptxas report, one JSON line per shape and one object
at the end, also written to ``--out``.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

BUILD = ROOT / "build" / "likelihood_any_q_ab"
GRAPH_BUDGET_MS = 300.0  # device time of one graph_ms capture, roughly
# State counts the earlier source ran in its fixed kernels, which summed as
# the compiler contracted them: their rows may differ from the current
# explicit chain by rounding, and are reported (``drifted``), not failed.
FIXED_EARLIER = (4, 20)


def smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def ptxas_lines(log: str) -> list[str]:
    return [ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln or "Function properties" in ln
            or "Compiling entry" in ln]


def earlier_plan(n_leaves: int, q: int, shared_p: bool, masks: bool, smem_optin: int):
    """The earlier wrapper's launch plan (Q = 4 and 20 fixed, else its
    runtime-Q kernel: ceil(Q / 16) threads a site, P transposed at a pitch of
    Q rounded up to 16, a float a thread for the tiles' maxima)."""
    from trex_tpu_torch.ops.likelihood_cuda import leaf_codes
    from trex_tpu_torch.ops.tree_plan import slot_plan, slots_for

    slots = slots_for(n_leaves)
    if q in (4, 20):
        codes = leaf_codes(q, shared_p, masks)
        fixed = 4 * (q * q if shared_p else 0) + 4 * codes * q
        return slot_plan(slots, 4 * slots * q, fixed, smem_optin, widths=(128,),
                         leaf_table=codes > 0)
    pitch = -(-q // 16) * 16
    tiles = pitch // 16
    p_bytes = 4 * q * pitch if shared_p else 0
    table_bytes = 4 * (q + 2) * pitch
    table = shared_p and not masks and p_bytes + table_bytes <= smem_optin // 2
    return slot_plan(slots, 4 * (tiles + slots * q), p_bytes + (table_bytes if table else 0),
                     smem_optin, threads_per_site=tiles, max_threads=512,
                     global_column_bytes=4 * tiles, leaf_table=table)


def build_earlier(source: Path) -> tuple[ctypes.CDLL, list[str], float]:
    from trex_tpu_torch.ops import _nvcc

    BUILD.mkdir(parents=True, exist_ok=True)
    lib_path = BUILD / "liblikelihood_batched_earlier.so"
    t0 = time.perf_counter()
    done = subprocess.run(
        [_nvcc._nvcc(), *_nvcc.NVCC_FLAGS, "-o", str(lib_path), str(source)],
        capture_output=True, text=True,
    )
    seconds = time.perf_counter() - t0
    if done.returncode:
        raise RuntimeError(f"nvcc failed for {source}:\n{done.stdout}{done.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    fn = lib.trex_likelihood_batched
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 12 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, ptxas_lines(done.stdout + done.stderr), seconds


def drift(rows, old_rows, sums, old_sums) -> dict:
    """How far the current rows and sums lie from the earlier build's: the
    rows that differ, their largest distance in units in the last place,
    and the sums' largest absolute and relative difference."""
    import torch

    ulps = (rows.view(torch.int32).to(torch.int64)
            - old_rows.view(torch.int32).to(torch.int64)).abs()
    gap = (sums - old_sums).abs()
    return dict(rows_differing=int((rows != old_rows).sum()), rows=int(rows.numel()),
                rows_max_ulps=int(ulps.max()), sums_max_abs_diff=float(gap.max()),
                sums_max_rel_diff=float((gap / old_sums.abs()).max()))


def forced_global(plan, row_states: int):
    """``plan`` with its slots moved to the global-slot mode: the same block
    width, no slot columns in shared memory."""
    if plan.mode == "global":
        return plan
    return dataclasses.replace(plan, mode="global", smem_bytes=plan.smem_bytes
                               - 4 * plan.slots * row_states * plan.sites_per_block)


def main() -> int:
    import numpy as np
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("earlier", type=Path)
    parser.add_argument("--out", type=Path, default=BUILD / "likelihood_any_q_ab.json")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("likelihood_any_q_ab: no CUDA device", file=sys.stderr)
        return 1
    from trex_tpu_torch._device import device_limits
    from trex_tpu_torch.io import nni_neighbors_host
    from trex_tpu_torch.models import codon as cd
    from trex_tpu_torch.ops import _nvcc
    from trex_tpu_torch.ops import likelihood_cuda as lc
    from trex_tpu_torch.ops.likelihood import gtr_generator
    from trex_tpu_torch.ops.tree_plan import tree_plan
    from trex_tpu_torch.topology import from_numpy, parents_from_children

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    _nvcc.build(["tree_plan", "likelihood_batched"])
    current_s = time.perf_counter() - t0
    lib, earlier_ptxas, earlier_s = build_earlier(args.earlier)
    smem_optin = device_limits(dev).smem_optin
    result = {
        "nvidia_smi": smi("name,power.limit"), "device": torch.cuda.get_device_name(0),
        "nvcc_s": {"current (with tree_plan.cu, in parallel)": current_s,
                   "earlier": earlier_s},
        "ptxas": {"current": ptxas_lines(_nvcc.BUILD_LOG.get("likelihood_batched", "")),
                  "earlier": earlier_ptxas},
        "shapes": [],
    }
    print(json.dumps({k: result[k] for k in ("nvidia_smi", "nvcc_s", "ptxas")}), flush=True)

    def earlier_call(children, leaves, weights, prior, transition, masks, plan):
        lc._check(children, leaves, weights, prior, transition, masks)
        batch, n_anc, _ = children.shape
        length, q = leaves.shape[1], prior.shape[0]
        shared = transition.dim() == 2
        steps = tree_plan(children)
        chunk = min(batch, 65535)
        slots_g = None
        if plan.mode == "global":
            per_tree = 4 * plan.slots * q * length
            chunk = max(1, min(chunk, lc.GLOBAL_SLOT_BYTES // per_tree))
            slots_g = torch.empty((chunk * per_tree // 4,), dtype=torch.float32, device=dev)
        rows = torch.empty((batch, length), dtype=torch.float32, device=dev)
        out = torch.empty((batch,), dtype=torch.float32, device=dev)
        rc = lib.trex_likelihood_batched(
            steps.data_ptr(), children.data_ptr(), leaves.data_ptr(), transition.data_ptr(),
            prior.data_ptr(), weights.data_ptr(),
            None if slots_g is None else slots_g.data_ptr(), rows.data_ptr(), out.data_ptr(),
            batch, n_anc + 1, length, q, int(shared), int(masks), plan.slots,
            plan.sites_per_block, int(plan.mode == "global"),
            int(plan.leaf_table and q not in (4, 20)), chunk, plan.smem_bytes,
            torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"earlier K3/K4 launch failed: CUDA error {rc}")
        return out, rows

    def with_plan(plan, fn):
        """``fn()`` with ``lc.launch_plan`` returning ``plan`` (None: its own)."""
        if plan is None:
            return fn()
        chosen = lc.launch_plan
        lc.launch_plan = lambda *a: plan
        try:
            return fn()
        finally:
            lc.launch_plan = chosen

    failures, drifted = [], []

    def case(key, children, leaves, weights, prior, transition, masks=False, force=False,
             other_mode=False):
        n_leaves, length = leaves.shape
        q = prior.shape[0]
        shared = transition.dim() == 2
        plan = lc.launch_plan(n_leaves, q, shared, masks, smem_optin)
        old_plan = earlier_plan(n_leaves, q, shared, masks, smem_optin)
        if force:
            plan = forced_global(plan, lc.slot_states(q))
            old_plan = forced_global(old_plan, q)
        forced = plan if force else None

        def cur():
            return with_plan(forced, lambda: lc.batched_log_likelihood_cuda(
                children, leaves, weights, prior, transition, sequences_are_masks=masks,
                per_site=True))

        def old():
            return earlier_call(children, leaves, weights, prior, transition, masks, old_plan)

        row = dict(shape=key, trees=int(children.shape[0]), n_taxa=n_leaves, patterns=length,
                   n_states=q, per_branch=not shared, masks=masks,
                   kernel_width=lc.kernel_width(q), plan=dataclasses.asdict(plan),
                   earlier_plan=dataclasses.asdict(old_plan))
        try:
            want_sums, want_rows = lc.batched_log_likelihood_plain(
                children, leaves, weights, prior, transition, sequences_are_masks=masks,
                per_site=True)
            got_sums, got_rows = cur()
            old_sums = old()[0]
            # The earlier kernel's rows under unit weights, as per_site=True's.
            old_rows = earlier_call(children, leaves, torch.ones_like(weights), prior,
                                    transition, masks, old_plan)[1]
            torch.cuda.synchronize()
            # The current call's sums are the rows' weighted sum (per_site=True);
            # the site-sum kernel's are held below through the default call.
            cur_sums = with_plan(forced, lambda: lc.batched_log_likelihood_cuda(
                children, leaves, weights, prior, transition, sequences_are_masks=masks))
            for name, x in (("current", cur_sums), ("earlier", old_sums)):
                rel = float(((x - want_sums).abs() / want_sums.abs()).max())
                row[f"{name}_max_rel_err"] = rel
                if not rel <= chip_smoke.K34_RTOL:
                    raise AssertionError(f"{name} rel err {rel} > {chip_smoke.K34_RTOL}")
            row["rows_equal_to_earlier"] = bool(torch.equal(got_rows, old_rows))
            row["sums_equal_to_earlier"] = bool(torch.equal(cur_sums, old_sums))
            row["rows_max_rel_err"] = float(((got_rows - want_rows).abs()
                                             / want_rows.abs()).max())
            row.update(drift(got_rows, old_rows, cur_sums, old_sums))
            if not (row["rows_equal_to_earlier"] and row["sums_equal_to_earlier"]):
                if q not in FIXED_EARLIER:
                    raise AssertionError("current and earlier kernels differ")
                drifted.append(key)

            def cur_call():
                return with_plan(forced, lambda: lc.batched_log_likelihood_cuda(
                    children, leaves, weights, prior, transition, sequences_are_masks=masks))

            def old_call():
                return old()[0]

            one = chip_smoke.time_ms(torch, cur_call, 3, 1)
            reps = max(3, min(30, int(300 / max(one, 1e-3))))
            calls = max(2, min(20, int(GRAPH_BUDGET_MS / max(one, 1e-3))))
            turns = {"earlier": [], "current": []}
            for name, fn in (("earlier", old_call), ("current", cur_call),
                             ("current", cur_call), ("earlier", old_call)):
                turns[name].append({"ms": chip_smoke.time_ms(torch, fn, reps),
                                    "graph_ms": chip_smoke.graph_ms(torch, fn, calls, 3)})
            row.update(turns=turns, reps=reps, graph_calls=calls,
                       bound=chip_smoke.bound_ms(*chip_smoke.k34_work(
                           int(children.shape[0]), n_leaves, int((weights != 0).sum()), q,
                           not shared)),
                       sm_clock=smi("clocks.sm"))
            if other_mode:  # the current kernel in the slot mode its plan did not take
                own = lc.launch_plan(n_leaves, q, shared, masks, smem_optin)
                columns = 4 * own.slots * lc.slot_states(q) * own.sites_per_block
                if own.mode == "shared":
                    alt = forced_global(own, lc.slot_states(q))
                elif own.smem_bytes + columns <= smem_optin:
                    alt = dataclasses.replace(own, mode="shared",
                                              smem_bytes=own.smem_bytes + columns)
                else:
                    alt = None
                if alt is not None:
                    def alt_call():
                        return with_plan(alt, lambda: lc.batched_log_likelihood_cuda(
                            children, leaves, weights, prior, transition,
                            sequences_are_masks=masks))
                    same = bool(torch.equal(alt_call(), cur_sums))
                    row["other_mode"] = {"plan": dataclasses.asdict(alt), "equal": same,
                                         "graph_ms": chip_smoke.graph_ms(torch, alt_call,
                                                                         calls, 3)}
        except Exception as exc:  # record and go on: one call shows every shape
            row["error"] = f"{type(exc).__name__}: {exc}"
            failures.append(key)
        print(json.dumps(row), flush=True)
        result["shapes"].append(row)

    rng = np.random.default_rng(chip_smoke.SEED + 61)
    # The codon neighbourhood: a random 64-taxon tree's NNI neighbours.
    n, length = 64, 1000
    tree = chip_smoke.random_trees(rng, n, 1)[0]
    nbrs = torch.as_tensor(nni_neighbors_host(from_numpy(tree, parents_from_children(tree)))[0],
                           device=dev)
    codons = torch.as_tensor(rng.integers(0, 61, (n, length)).astype(np.int32), device=dev)
    counts = torch.as_tensor(rng.integers(1, 4, length).astype(np.float32), device=dev)
    freqs = torch.as_tensor(rng.dirichlet(np.full(61, 5.0)).astype(np.float32), device=dev)
    gen = cd.gy94_generator(2.0, 0.3, freqs)
    shared61 = torch.linalg.matrix_exp(gen * 0.1).contiguous()
    lengths = torch.as_tensor(rng.uniform(0.02, 0.5, 2 * n - 1).astype(np.float32), device=dev)
    branch61 = torch.linalg.matrix_exp(gen * lengths[:, None, None])
    branch61 = branch61[None].expand(nbrs.shape[0], -1, -1, -1).contiguous()
    case("dnds_shared", nbrs, codons, counts, freqs, shared61, other_mode=True)
    case("dnds_per_branch", nbrs, codons, counts, freqs, branch61, other_mode=True)
    del branch61
    n, length, batch = chip_smoke.K34_Q61_WIDE.values()
    wide = torch.as_tensor(chip_smoke.random_trees(rng, n, batch), device=dev)
    wide_leaves = torch.as_tensor(rng.integers(0, 61, (n, length)).astype(np.int32), device=dev)
    ones = torch.ones((length,), device=dev)
    case("wide_512", wide, wide_leaves, ones, freqs, shared61)
    case("wide_512_global", wide, wide_leaves, ones, freqs, shared61, force=True)
    wide_lengths = torch.as_tensor(rng.uniform(0.02, 0.5, 2 * n - 1).astype(np.float32),
                                   device=dev)
    wide_branch = torch.linalg.matrix_exp(gen * wide_lengths[:, None, None])
    wide_branch = wide_branch[None].expand(batch, -1, -1, -1).contiguous()
    case("wide_512_per_branch", wide, wide_leaves, ones, freqs, wide_branch, other_mode=True)
    del wide_branch

    n, length, batch = chip_smoke.K34_Q5.values()
    rates = rng.gamma(2.0, 1.0, (5, 5))
    prior5 = torch.as_tensor(rng.dirichlet(np.full(5, 5.0)).astype(np.float32), device=dev)
    p5 = torch.linalg.matrix_exp(gtr_generator(torch.as_tensor((rates + rates.T) / 2,
                                                               device=dev), prior5) * 0.1)
    states5 = rng.integers(0, 5, (n, length)).astype(np.int32)
    states5[rng.random(states5.shape) < 0.05] = -1
    case("q5", torch.as_tensor(chip_smoke.random_trees(rng, n, batch), device=dev),
         torch.as_tensor(states5, device=dev), torch.ones((length,), device=dev), prior5,
         p5.contiguous())
    # The small-Q shapes, Q = 21 per branch, and Q = 4 and 20 (the fixed
    # kernels the earlier source had), Q = 4 on masks also at the main
    # path's K3/K4 shape (K34_SHAPE, as the ML routes score DNA).
    for q, masks, per_branch in chip_smoke.K34_SMALL_Q + (
            (21, False, True), (4, False, False), (4, True, False), (4, False, True),
            (20, False, False), (20, False, True)):
        key = f"q{q}" + ("_masks" if masks else "") + ("_per_branch" if per_branch else "")
        case(key, *chip_smoke.small_q_inputs(torch, dev, rng, q, masks, per_branch),
             masks=masks, other_mode=per_branch and q > lc.WIDTHS[-1])
    for per_branch in (False, True):
        key = "main_q4_masks" + ("_per_branch" if per_branch else "")
        case(key, *chip_smoke.small_q_inputs(torch, dev, rng, 4, True, per_branch,
                                             size=chip_smoke.K34_SHAPE), masks=True)

    result["failures"], result["drifted"] = failures, drifted
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(result, indent=1))
    print(json.dumps({"failures": failures, "drifted": drifted}))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
