"""Find the online cell's capacity once (not run by the benchmark's runs):
the cell's set-up once, then a window at each offered rate, each printing
the p50 / p95 latency, the batch fill and whether the backlog grew (the
median latency of the window's last quarter of requests over its first).

    python3 -m benchmark.sweep --workload <online cell> --seed <n> --seconds 6 --rates 100,200,300
"""

from __future__ import annotations

import argparse
import gc
import json
import sys

import numpy as np
import torch

from benchmark.core import ROOT, load_cell
from benchmark.drivers.online import Session
from benchmark.trace import Tracer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--rates", required=True)
    args = ap.parse_args(argv)
    from cerberusdet_tpu_torch.serve.server import BatchingEngine

    cell = load_cell(args.workload, ROOT)
    s = Session(cell, args.seed, torch.device("cuda", 0), Tracer(False))
    gc.collect()
    gc.freeze()  # as run.py does after set-up
    tr = cell.traffic
    for rate in [float(r) for r in args.rates.split(",")]:
        tr["rate_per_s"] = rate
        s.engine = BatchingEngine(s.calls, s.calls, max_batch=int(tr["max_batch"]),
                                  max_wait_ms=float(tr["max_wait_ms"]))
        s.calls.calls.clear()
        s.window(args.seconds)
        lat = np.array(s.record["latency_ms"])
        q = max(1, len(lat) // 4)
        rows = s.record["batch_rows"]
        print(json.dumps({"rate": rate, "served_per_s": s.record["images"] / s.record["window_s"],
                          "p50_ms": float(np.percentile(lat, 50)),
                          "p95_ms": float(np.percentile(lat, 95)),
                          "growth": float(np.median(lat[-q:]) / np.median(lat[:q])),
                          "fill_pct": 100.0 * sum(rows) / (len(rows) * int(tr["max_batch"])),
                          "lateness_p99_ms": s.record["lateness_p99_ms"],
                          "failed": s.record["failed"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
