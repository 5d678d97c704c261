"""Run one benchmark cell once, as the driver calls it:

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Set-up (weights and frames from the seed, the
program built and every shape the cell uses warmed and captured), then the
measured window, then the peak memory, then the program freed and its
answers checked against the reference. With --trace 1 a second window of
the same length follows the first under the profiler: the metrics that read
the device trace come from it, those on the host clock from the first,
which the profiler does not slow. The last line of standard output is one
JSON object: correct, attempted, failed, metrics (the cell's end-to-end
metrics with --trace 0, its per-layer metrics with --trace 1), device and
the compared numbers with their limits; the last lines of standard error
repeat the compared numbers.

Exits 2 without a result when the card (or as many as the cell asks for) is
missing, 3 when a JAX module is loaded once the window has closed.
"""

from __future__ import annotations

import os
import time


def _since_start() -> float:
    """Seconds since this process started (Linux /proc), 0 where unknown."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        return time.clock_gettime(time.CLOCK_BOOTTIME) - ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, AttributeError):
        return 0.0


T0 = time.perf_counter() - _since_start()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

from benchmark.core import ROOT, forbidden_modules, judge, load_cell, reader, result_line  # noqa: E402

# caches inside the checkout, at fixed paths; libraries kept from loading JAX
CACHE = ROOT / ".bench_cache"
os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE / "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(CACHE / "torch_extensions"))
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, device=None, root=ROOT) -> int:
    """device: None asks for the card (the driver's runs); a test passes
    torch.device("cpu") to drive the rest of a run without one."""
    args = parse(argv)
    cell = load_cell(args.workload, root)
    import torch

    from benchmark.trace import Tracer

    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"benchmark: {args.workload} needs {cell.chips} CUDA device(s), found {n}",
                  file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.init()
        torch.cuda.set_device(device)
    tracer = Tracer(bool(args.trace) and on_card)
    driver = importlib.import_module(f"benchmark.drivers.{cell.traffic['kind']}")
    session = driver.Session(cell, args.seed, device, tracer)
    # the set-up's objects leave the cyclic collector's scans, as a long-running
    # server's old objects do: the window's collections are those of its own objects
    gc.collect()
    gc.freeze()
    session.window(args.seconds)
    record = session.record
    traced = None
    if args.trace:
        with tracer.window():
            session.window(args.seconds)
        traced = session.record
    gc.unfreeze()
    record["setup_s"] = record["t0"] - T0
    windows = [record] + ([traced] if traced else [])
    attempted = sum(w["requests"] for w in windows)
    failed = sum(w["failed"] for w in windows)
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0  # the program's (since its build)
    session.release()
    compared = session.check()
    correct = judge(compared, cell.limits) and failed == 0
    cfg, size = cell.config, cell.traffic["img_size"]
    ctx = types.SimpleNamespace(
        record=record, traced=traced, trace=tracer.result, traffic=cell.traffic,
        config=cfg, family=cell.family, precision=cell.traffic["precision"],
        work=cell.family.convs(cfg["model"], cfg["tasks"], cfg["nc"], size, size))
    wanted = cell.per_layer if args.trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        v = reader(m["name"], root)(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else device.type,
           "kind": torch.cuda.get_device_name(device) if on_card else device.type,
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    breakdown = None
    if tracer.result is not None:
        dev["busy_s"], dev["window_s"] = tracer.result.busy_s, tracer.result.window_s
        breakdown = tracer.result.breakdown()
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: loaded after the window: {', '.join(bad)}", file=sys.stderr)
        return 3
    keys = ("requests", "failed", "window_s", "captures_in_window", "launches", "lateness_p99_ms")
    info = {k: record[k] for k in keys if k in record}
    if traced:
        info["traced_window"] = {k: traced[k] for k in keys if k in traced}
    if tracer.result is not None:
        info["trace_records"] = {k: v[0] for k, v in tracer.result.by_category().items()}
    info["confident_detections"] = getattr(session, "confident", None)
    print("benchmark: " + json.dumps(info), file=sys.stderr)
    for k, v in cell.limits["numbers"].items():
        print(f"compared {k} {compared[k]!r} limit {v['limit']!r}", file=sys.stderr)
    print(result_line(correct, attempted, failed, metrics, dev, compared,
                      cell.limits, breakdown), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
