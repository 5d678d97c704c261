"""Split a cell's device idle over the port's spans (not run by the
benchmark's runs): the cell's set-up once, an untraced window, then one of
--seconds under the profiler; the trace and a dump of the port's ring
(cerberusdet_tpu_torch/utils/tracing.py) are written under --out and
summarized by cerberusdet_tpu_torch/tools/summarize_trace.py --ring, so
that the spans of every thread, the serving engine's runner's too, split
the idle.

    python3 -m benchmark.idle --workload <cell> --seed <n> --seconds 6 [--out DIR]
"""

from __future__ import annotations

import argparse
import gc
import importlib
import sys
import tempfile
from pathlib import Path

import torch

from benchmark.core import ROOT, load_cell
from benchmark.trace import Tracer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--out", help="where the trace and the ring go (a new temporary directory "
                    "by default)")
    args = ap.parse_args(argv)
    from torch.profiler import ProfilerActivity, profile

    from cerberusdet_tpu_torch.tools import summarize_trace
    from cerberusdet_tpu_torch.utils import tracing

    cell = load_cell(args.workload, ROOT)
    driver = importlib.import_module(f"benchmark.drivers.{cell.traffic['kind']}")
    s = driver.Session(cell, args.seed, torch.device("cuda", 0), Tracer(False))
    gc.collect()
    gc.freeze()  # as run.py does after set-up
    s.window(args.seconds)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        # spans of this thread, in the trace and in the ring: they align by them
        with tracing.span("clock"):
            pass
        s.window(args.seconds)
        with tracing.span("clock"):
            pass
        torch.cuda.synchronize()
    gc.unfreeze()
    out = Path(args.out or tempfile.mkdtemp(prefix="idle_"))
    out.mkdir(parents=True, exist_ok=True)
    trace = out / f"{args.workload}.{args.seed}.pt.trace.json"
    ring = out / f"{args.workload}.{args.seed}.ring.npz"
    prof.export_chrome_trace(str(trace))
    tracing.save(ring)
    s.release()
    print(f"{args.workload} seed {args.seed}: {args.seconds} s profiled, trace {trace}, ring "
          f"{ring}", flush=True)
    summarize_trace.main([str(trace), "--ring", str(ring), "--top", "8", "--min-ms", "50"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
