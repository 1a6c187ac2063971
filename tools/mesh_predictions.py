#!/usr/bin/env python3
"""Predicted multi-GPU efficiency of the port's sharded paths, from the
collective-volume model (``trex_tpu_torch/parallel/comm_model.py``) and one
card's measured compute.

    python3 tools/mesh_predictions.py LOG [--link-gbps 450] [--latency-us 20]

``LOG`` is the output of ``chip_smoke.py --phases mesh`` (JSON lines). It
reads the compute of one card from it: K1 on the main path's NNI batch
(``mesh_b``'s ``k1_at_tile`` ms: 1020 trees, 512 taxa x 2048 patterns),
one SPR-scan round at the main path's tree (``mesh_a``'s profiled window
wall), the default ``infer``'s stepwise start and SPR-scan climb at 512 x
2048 (``mesh_a``'s single-device seconds) and the single-device batched
Newton fit of aLRT's candidates at 512 x 2048 (``mesh_c``'s supports
route, its single-device ``alrt_parts`` fit). For each mesh shape, the
compute is taken to divide evenly over the ranks that split it, and the collectives to run without overlap at
``--link-gbps`` GB/s a rank plus ``--latency-us`` each (assumptions: an
H100 SXM's NVLink gives 450 GB/s each way, PCIe cards far less; a small
NCCL collective within a node takes some tens of microseconds), so each
figure is a prediction, not a measurement: ``comm_model``'s bandwidth-only
efficiency, and the efficiency with the latency term. The collectives are
those the port emits: ``comm_model``'s, with the scores' gather over
'tree' that ``sharded_batch_scores`` adds and the four scalars a rank of
``sharded_spr_scan_best`` in place of the scan table's gather. The
default ``infer``'s end to end: every rank runs the stepwise start whole,
so only the climb divides (over 'tree').
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from trex_tpu_torch.parallel import comm_model as cm  # noqa: E402

SHAPES = ((1, 2), (2, 1), (2, 2), (1, 4), (4, 1), (2, 4), (8, 1))


def _measured(log: str) -> dict:
    found = {}
    with open(log) as fh:
        for line in fh:
            if not line.startswith('{"phase": "mesh_'):
                continue
            row = json.loads(line)
            if row["phase"] == "mesh_a":
                found["scan_s"] = row["profile"]["wall_s"]
                found["start_s"] = row["seconds"]["1,1"]["start"]
                found["climb_s"] = row["seconds"]["1,1"]["climb"]
            elif row["phase"] == "mesh_b":
                found["k1_ms"] = row["k1_at_tile"]["ms"]
            elif row["phase"] == "mesh_c" and "--alrt" in row["command"]:
                found["fit_s"] = row["single_device_seconds"]["alrt_parts"]["fit"]
    missing = {"scan_s", "start_s", "climb_s", "k1_ms", "fit_s"} - set(found)
    if missing:
        raise SystemExit(f"{log}: no mesh_a / mesh_b / mesh_c line with {sorted(missing)}")
    return found


def _with_latency(collectives, compute_s: float, link: float, latency_s: float) -> float:
    comm = sum(c.wire_bytes_per_device for c in collectives) / link
    comm += latency_s * sum(c.participants > 1 for c in collectives)
    return compute_s / (compute_s + comm)


def predictions(k1_ms: float, scan_s: float, fit_s: float, start_s: float, climb_s: float,
                link_bytes_per_s: float, latency_s: float) -> list[dict]:
    rows = []
    for t, s in SHAPES:
        shape = {"tree": t, "site": s}
        batch = 1020
        scores = cm.batch_scoring_collectives(shape, batch) + [
            cm.Collective("all_gather", "tree", t, batch * 4)]
        scan = [cm.Collective("all_gather", "tree", t, t * 4 * 8)]
        fit = cm.per_site_matrix_collectives(shape, 1022, 2048)
        # The scan and the fit split over 'tree' only.
        parts = {"k1_batch": (scores, k1_ms / 1e3 / (t * s)), "scan_round": (scan, scan_s / t),
                 "per_site_fit": (fit, fit_s / t)}
        row = {"mesh": f"{t},{s}"}
        for name, (collectives, compute) in parts.items():
            row[name] = {
                "bandwidth_only": cm.predicted_efficiency(collectives, compute,
                                                          link_bytes_per_s),
                "with_latency": _with_latency(collectives, compute, link_bytes_per_s,
                                              latency_s),
            }
        speedup = (start_s + climb_s) / (start_s + climb_s / t)
        row["infer_default"] = {"speedup": speedup, "efficiency": speedup / (t * s)}
        rows.append(row)
    return rows


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("log")
    parser.add_argument("--link-gbps", type=float, default=450.0)
    parser.add_argument("--latency-us", type=float, default=20.0)
    args = parser.parse_args()
    found = _measured(args.log)
    out = {"assumed_link_gb_per_s": args.link_gbps, "assumed_latency_us": args.latency_us,
           "measured": found,
           "predicted_efficiency": predictions(
               found["k1_ms"], found["scan_s"], found["fit_s"], found["start_s"],
               found["climb_s"], args.link_gbps * 1e9, args.latency_us * 1e-6)}
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
