"""Summarize a torch.profiler trace (from tools/profile_step.py) without a viewer.

The port's counterpart of cerberusdet_tpu/tools/summarize_trace.py: device
time per kernel category and the top kernels, straight from the Chrome
trace (*.pt.trace.json or .json.gz) that utils/profiling.py:trace writes,
divided by the loop count profile_step ran:

    python -m cerberusdet_tpu_torch.tools.profile_step --out DIR --iters 5
    python -m cerberusdet_tpu_torch.tools.summarize_trace DIR --iters 5 [--top 20] [--min-ms 0.2]

Device events are the trace's kernels, copies and sets (cat "kernel",
"gpu_memcpy", "gpu_memset"). Categories, by kernel name in this order: the
port's kernels (conv_s8, quant_pack_s8, quant_s8, NMS, TAL), conv / gemm
(cuDNN's and cuBLAS's), elementwise (PyTorch's elementwise and reduction
kernels), memcpy (copies and sets), other. A trace of a CPU run holds no
device events; the summary says so.

The device's idle time, from its first activity to its last, is listed by
the innermost of the port's spans (utils/tracing.py: host ranges named
"cd." + the span's name, on the device's clock) open at each moment of it,
"outside any cd. span" where none is: which host work the card waited for.
The profiler records the ranges of the thread that started it only. The
spans of the process's other threads (the serving engine's runner) come
from a dump of its ring (`tracing.save`, written after the profile):

    python -m cerberusdet_tpu_torch.tools.summarize_trace TRACE --ring RING.npz

places the ring's spans on the trace's clock by the spans both hold (the
profiling thread's: at least one `tracing.span` has to be open inside the
profile there) and splits the idle over every thread's spans. A request's
`queue` span is its wait, not host work, and splits nothing.
"""

from __future__ import annotations

import argparse
import collections
import gzip
import heapq
import json
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

from cerberusdet_tpu_torch.utils.tracing import PROFILER_PREFIX, SPAN

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
OUTSIDE = "outside any cd. span"  # idle time while no span of the port is open
# (category, name fragments), first match wins
CATEGORIES = (
    ("conv_s8", ("conv_s8_kernel",)),
    ("quant_pack_s8", ("quant_pack",)),
    ("quant_s8", ("quant_nchw_kernel",)),
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


def load_trace(path) -> List[Dict]:
    """Every complete ("X") event of a trace."""
    f = trace_file(path)
    opener = gzip.open if f.suffix == ".gz" else open
    with opener(f, "rt") as fh:
        data = json.load(fh)
    return [e for e in data.get("traceEvents", []) if e.get("ph") == "X"]


def device_events(events: List[Dict]) -> List[Dict]:
    return [e for e in events if e.get("cat") in DEVICE_CATS]


def host_spans(events: List[Dict],
               prefix: str = PROFILER_PREFIX) -> List[Tuple[str, float, float]]:
    """(name without the prefix, start us, end us) of the host ranges whose
    name starts with `prefix` (the device's own copies of annotations are
    left out)."""
    return [(e["name"][len(prefix):], e["ts"], e["ts"] + e["dur"]) for e in events
            if e["name"].startswith(prefix) and e.get("cat") not in DEVICE_CATS
            and e.get("cat") != "gpu_user_annotation"]


def idle_gaps(device: List[Dict]) -> List[Tuple[float, float]]:
    """The intervals (us) between the device's first activity and its last
    in which none ran."""
    gaps, end = [], None
    for e in sorted(device, key=lambda e: e["ts"]):
        if end is not None and e["ts"] > end:
            gaps.append((end, e["ts"]))
        end = e["ts"] + e["dur"] if end is None else max(end, e["ts"] + e["dur"])
    return gaps


def idle_by_span(gaps: List[Tuple[float, float]], spans: List[Tuple[str, float, float]],
                 outside: str = OUTSIDE) -> Dict[str, float]:
    """{span name: idle us}: the gaps split over the innermost span open at
    each moment of them (the shortest of those open), `outside` where none
    is."""
    out: Dict[str, float] = collections.defaultdict(float)
    if not gaps:
        return {}
    ga = np.array([g[0] for g in gaps], np.float64)
    gb = np.array([g[1] for g in gaps], np.float64)
    order = np.argsort(ga)
    ga, gb = ga[order], gb[order]
    done = np.concatenate([[0.0], np.cumsum(gb - ga)])

    def idle_before(t):
        k = np.searchsorted(ga, t, side="right")  # the gaps that start by t
        return done[k] - np.where(k > 0, np.maximum(gb[k - 1] - t, 0.0), 0.0)

    # sweep the spans' edges, keeping the open ones in a heap by length
    edges = sorted([(a, 1, i) for i, (_, a, b) in enumerate(spans) if b > a]
                   + [(b, 0, i) for i, (_, a, b) in enumerate(spans) if b > a])
    heap, closed, cuts, names = [], set(), [], []
    for t, opens, i in edges:
        if opens:
            heapq.heappush(heap, (spans[i][2] - spans[i][1], i))
        else:
            closed.add(i)
        while heap and heap[0][1] in closed:
            heapq.heappop(heap)
        cuts.append(t)
        names.append(spans[heap[0][1]][0] if heap else None)
    named = 0.0
    if cuts:
        idle = np.diff(idle_before(np.array(cuts, np.float64)))
        for name, us in zip(names, idle):
            if name is not None and us > 0:
                out[name] += float(us)
                named += float(us)
    rest = float(done[-1]) - named
    if rest > 0:
        out[outside] += rest
    return dict(out)


WAITS = ("queue",)  # spans that are a wait, not host work: they split no idle
ALIGN_US = 20.0  # a ring span and a trace range are one span within this


def ring_spans(path, traced: List[Tuple[str, float, float]]):
    """The spans of a ring dump (tracing.save), every thread's but WAITS,
    on the trace's clock, and {"matched", "traced", "offset_spread_us"}:
    how many of the trace's `traced` ranges (the profiling thread's spans)
    fell within ALIGN_US of a ring span of their name under the offset
    taken, of how many, and the spread of their offsets (us). The offset
    is the one that matches the most, tried from the first ranges against
    each ring span of their name and length."""
    with np.load(path) as f:
        rec, names = f["rec"], [str(n) for n in f["names"]]
    rec = rec[(rec["seq"] >= 0) & (rec["kind"] == SPAN)]
    rname = np.array(names + [""], dtype=object)[rec["name"]]
    t0, t1 = rec["t0"] / 1e3, rec["t1"] / 1e3
    starts = {}
    for n in set(rname):
        idx = np.flatnonzero(rname == n)
        starts[n] = idx[np.argsort(t0[idx])]
    mine = collections.defaultdict(list)  # the trace's ranges of each name the ring holds
    for n, a, _ in traced:
        if n in starts:
            mine[n].append(a)
    mine = {n: np.array(a) for n, a in mine.items()}

    def nearest(off):
        """Each traced range's start less the nearest ring start of its name."""
        out = [np.zeros(0)]
        for n, a in mine.items():
            st = np.concatenate([[-np.inf], t0[starts[n]] + off, [np.inf]])
            k = np.searchsorted(st, a)  # st[k - 1] < a <= st[k]
            out.append(np.where(a - st[k - 1] < st[k] - a, a - st[k - 1], a - st[k]))
        return np.concatenate(out)

    best, offsets = 0, None
    for name, a, b in [x for x in traced if x[0] in starts][:8]:
        idx = starts[name]
        for i in idx[np.abs((t1[idx] - t0[idx]) - (b - a)) <= ALIGN_US]:
            d = nearest(a - t0[i])
            near = d[np.abs(d) <= ALIGN_US]
            if len(near) > best:
                best, offsets = len(near), a - t0[i] + near
    if offsets is None:
        raise ValueError("no span of the ring is a cd. range of the trace: a tracing.span has "
                         "to be open inside the profile on the thread that profiled")
    off = float(np.median(offsets))
    keep = ~np.isin(rname, WAITS)
    spans = [(n, a + off, b + off) for n, a, b in zip(rname[keep], t0[keep], t1[keep])]
    return spans, {"matched": best, "traced": len(traced),
                   "offset_spread_us": float(offsets.max() - offsets.min())}


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
    p.add_argument("--ring", help="a dump of the traced process's ring (tracing.save): its "
                   "spans, every thread's, split the idle too")
    args = p.parse_args(argv)

    everything = load_trace(args.trace_dir)
    events = device_events(everything)
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
    k = args.iters * 1000.0
    spans, aligned = host_spans(everything), None
    if args.ring:
        spans, aligned = ring_spans(args.ring, spans)
        print(f"\nthe ring's spans on the trace's clock: {aligned['matched']} of the trace's "
              f"{aligned['traced']} cd. ranges matched, offsets within "
              f"{aligned['offset_spread_us']:.1f} us")
    idle = {n: us / k for n, us in idle_by_span(idle_gaps(events), spans).items()}
    idle_ms = sum(idle.values())
    print(f"\ndevice idle between its first and last activity: {idle_ms:.3f} ms/iter, by the "
          "innermost cd. span" + (" (the ring's, every thread)" if args.ring else "") + ":")
    for n, ms in sorted(idle.items(), key=lambda kv: -kv[1]):
        print(f"{ms:9.3f} ms/iter  {ms / idle_ms * 100:5.1f}%  {n}")
    return {"total_ms": total, "by_category": bycat, "events": len(events), "idle_by_span": idle,
            "aligned": aligned}


if __name__ == "__main__":
    main()
