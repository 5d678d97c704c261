"""Summarize a torch.profiler trace (from tools/profile_step.py) without a viewer.

The port's counterpart of cerberusdet_tpu/tools/summarize_trace.py: device
time per kernel category and the top kernels, straight from the Chrome
trace (*.pt.trace.json or .json.gz) that utils/profiling.py:trace writes,
divided by the loop count profile_step ran:

    python -m cerberusdet_tpu_torch.tools.profile_step --out DIR --iters 5
    python -m cerberusdet_tpu_torch.tools.summarize_trace DIR --iters 5 [--top 20] [--min-ms 0.2]

Device events are the trace's kernels, copies and sets (cat "kernel",
"gpu_memcpy", "gpu_memset"). Categories, by kernel name in this order: the
port's kernels (conv_s8, quant_pack_s8, NMS, TAL), conv / gemm (cuDNN's
and cuBLAS's), elementwise (PyTorch's elementwise and reduction kernels),
memcpy (copies and sets), other. A trace of a CPU run holds no device
events; the summary says so.
"""

from __future__ import annotations

import argparse
import collections
import gzip
import json
from pathlib import Path
from typing import Dict, List

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# (category, name fragments), first match wins
CATEGORIES = (
    ("conv_s8", ("conv_s8_kernel",)),
    ("quant_pack_s8", ("quant_pack",)),
    ("nms", ("nms_kernel",)),
    ("tal", ("tal_select_kernel", "tal_assign_kernel", "tal_norm_kernel")),
    ("conv / gemm", ("fprop", "dgrad", "wgrad", "convolve", "conv2d", "implicit_gemm", "gemm",
                     "gemv", "cutlass", "xmma", "nvjet")),
    ("elementwise", ("elementwise", "reduce_kernel", "Reduce", "CatArray", "index",
                     "softmax", "pooling", "upsample")),
)


def trace_file(path) -> Path:
    """The trace at `path`, or the newest *.pt.trace.json[.gz] under it."""
    path = Path(path)
    if path.is_file():
        return path
    files = sorted(list(path.rglob("*.pt.trace.json")) + list(path.rglob("*.pt.trace.json.gz")),
                   key=lambda p: p.stat().st_mtime)
    if not files:
        raise FileNotFoundError(f"no *.pt.trace.json[.gz] under {path}")
    return files[-1]


def load_events(path) -> List[Dict]:
    """The device events ("X" events of the device categories) of a trace."""
    f = trace_file(path)
    opener = gzip.open if f.suffix == ".gz" else open
    with opener(f, "rt") as fh:
        data = json.load(fh)
    return [e for e in data.get("traceEvents", [])
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]


def category(event: Dict) -> str:
    if event["cat"] != "kernel":
        return "memcpy"
    name = event["name"]
    for cat, frags in CATEGORIES:
        if any(f in name for f in frags):
            return cat
    return "other"


def summarize(events: List[Dict], iters: int = 1):
    """({category: ms an iteration}, {(category, name): [ms an iteration,
    count]}, total ms an iteration)."""
    k = iters * 1000.0  # us -> ms, per iteration
    bycat: Dict[str, float] = collections.defaultdict(float)
    byop: Dict = collections.defaultdict(lambda: [0.0, 0])
    for e in events:
        c = category(e)
        bycat[c] += e["dur"] / k
        op = byop[(c, e["name"])]
        op[0] += e["dur"] / k
        op[1] += 1
    return dict(bycat), dict(byop), sum(e["dur"] for e in events) / k


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("trace_dir", help="a trace file or a directory holding one")
    p.add_argument("--iters", type=int, default=1,
                   help="loop count the trace ran (divides all times)")
    p.add_argument("--top", type=int, default=20)
    p.add_argument("--min-ms", type=float, default=0.2,
                   help="per-iteration cutoff for the top-kernel list")
    args = p.parse_args(argv)

    events = load_events(args.trace_dir)
    bycat, byop, total = summarize(events, args.iters)
    print(f"device busy: {total:.3f} ms/iter ({len(events)} events / {args.iters} iters)"
          + ("" if events else ": the trace holds no device events (a CPU run)"))
    print("\nby category:")
    for c, ms in sorted(bycat.items(), key=lambda kv: -kv[1]):
        print(f"{ms:9.3f} ms/iter  {ms / total * 100:5.1f}%  {c}")
    print(f"\ntop kernels (>= {args.min_ms} ms/iter):")
    shown = 0
    for (c, n), (ms, cnt) in sorted(byop.items(), key=lambda kv: -kv[1][0]):
        if ms < args.min_ms or shown >= args.top:
            break
        shown += 1
        print(f"{ms:8.3f} ms/iter x{cnt:<5d} [{c}] {n[:140]}")
    return {"total_ms": total, "by_category": bycat, "events": len(events)}


if __name__ == "__main__":
    main()
