"""The readings a cell's limits are set from (not run by the benchmark's runs).

    python3 -m benchmark.readings --workload <cell> --seeds 1,2,... \
        --control-seeds 7,8,9 [--faults no_nms,no_cross_task --fault-seeds 4,5,6] \
        [--references '{"name": {reference spec}, ...}'] --seconds 3 \
        [--out readings.json]

Program: for each seed, the cell's set-up and a short window at the cell's
own load, then the comparison a run makes (each number's reading); for each
fault seed and each of faults.py's faults, the same with the fault planted
in the program first. Control: for each control seed, the reference with
its Convs quantized to the limits file's control precision put in the
program's place, over the same frames, against the compared reference.
--references (serving cells): read the program and the control against
each of these references too (serving.ServingSession.reference_lists'
specs), to choose the one the limits file names. One process, so the build
and the imports are paid once. Prints one JSON line a reading.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
from pathlib import Path

import torch

from benchmark.core import ROOT, load_cell
from benchmark.faults import plant
from benchmark.trace import Tracer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="", help="faults.py's faults, planted in the program")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--references", default="{}", help="JSON {name: reference spec}")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    cell = load_cell(args.workload, ROOT)
    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    driver = importlib.import_module(f"benchmark.drivers.{cell.traffic['kind']}")
    refs = json.loads(args.references)
    seeds = lambda text: [int(x) for x in text.split(",") if x]
    runs = [("", seed) for seed in seeds(args.seeds)]
    runs += [(f, seed) for f in args.faults.split(",") if f for seed in seeds(args.fault_seeds)]
    out = []

    def emit(row):
        print(json.dumps(row), flush=True)
        out.append(row)

    for fault, seed in runs:
        if fault and cell.traffic["kind"] == "train":
            s = driver.Session(cell, seed, device, Tracer(False), fault=fault)
        else:
            s = driver.Session(cell, seed, device, Tracer(False))
            if fault:
                plant(s, fault)
        s.window(args.seconds)
        s.release()
        row = {"side": "program", "fault": fault, "seed": seed, **s.check(),
               "requests": s.record["requests"], "failed": s.record["failed"],
               "captures_in_window": s.record["captures_in_window"],
               "confident": getattr(s, "confident", None), "look": getattr(s, "look_at", None)}
        if refs:
            row["by_reference"] = {k: s.check(spec)["unmatched_share"] for k, spec in refs.items()}
        emit(row)
        del s
    spec = cell.limits["control"]
    for seed in seeds(args.control_seeds):
        s = driver.Session(cell, seed, device, Tracer(False), program=False)
        row = {"side": "control", **spec, "seed": seed, **s.control(spec)}
        if refs:
            row["by_reference"] = {k: s.control(spec, ref)["unmatched_share"]
                                   for k, ref in refs.items()}
        emit(row)
        del s
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
