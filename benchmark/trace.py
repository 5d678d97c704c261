"""The device trace of a measured window, from torch.profiler, and its
reduction: device activity (kernels, copies, sets) inside the window, the
benchmark's own host spans, the busy time as the union of the activity's
intervals, and kernels by category.

The categories copy the port's tools/summarize_trace.py CATEGORIES, with
`quant_s8` (its quant_nchw_kernel) added, which that table lacks.

The profiler has been seen to drop records of launches (1-25% in earlier
chip runs). A dropped record can only lower `busy_s`, so the idle share can
read high by the dropped share, never low; each reader that divides by a
kernel family's device time says how it keeps a dropped record from
raising its share.
"""

from __future__ import annotations

import collections
import contextlib
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

WINDOW = "bench.window"
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


def category(name: str) -> str:
    if name.startswith("Memcpy") or name.startswith("Memset"):
        return "memcpy"
    for cat, frags in CATEGORIES:
        if any(f in name for f in frags):
            return cat
    return "other"


class Trace(NamedTuple):
    window_s: float
    busy_s: float
    device: List[Tuple[str, float, float]]     # (name, start s, end s) from the window's start
    spans: List[Tuple[str, float, float]]      # the benchmark's host spans, same clock

    def by_name(self) -> Dict[str, Tuple[int, float]]:
        out: Dict[str, list] = collections.defaultdict(lambda: [0, 0.0])
        for name, a, b in self.device:
            out[name][0] += 1
            out[name][1] += b - a
        return {k: (v[0], v[1]) for k, v in out.items()}

    def by_category(self) -> Dict[str, Tuple[int, float]]:
        out: Dict[str, list] = collections.defaultdict(lambda: [0, 0.0])
        for name, (n, s) in self.by_name().items():
            out[category(name)][0] += n
            out[category(name)][1] += s
        return {k: (v[0], v[1]) for k, v in out.items()}

    def idle_gaps(self) -> List[Tuple[float, float]]:
        """The window's intervals with no device activity."""
        gaps, t = [], 0.0
        for a, b in union(self.device):
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if t < self.window_s:
            gaps.append((t, self.window_s))
        return gaps

    def breakdown(self) -> dict:
        """The 10 device operations that took most time, and the idle time by
        the innermost benchmark span around each gap's middle."""
        ops = sorted(self.by_name().items(), key=lambda kv: -kv[1][1])[:10]
        idle: Dict[str, float] = collections.defaultdict(float)
        for a, b in self.idle_gaps():
            mid = (a + b) / 2
            inner = [s for s in self.spans if s[1] <= mid <= s[2]]
            name = min(inner, key=lambda s: s[2] - s[1])[0] if inner else "outside any span"
            idle[name] += b - a
        gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k, v[1]] for k, v in ops], "idle_gaps": [[k, v] for k, v in gaps]}


def union(intervals) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for _, a, b in sorted(intervals, key=lambda x: x[1]):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


class Tracer:
    """Profiles the window when enabled; `span(name)` marks host work."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.prof = None
        self.result: Optional[Trace] = None

    @contextlib.contextmanager
    def window(self):
        if not self.enabled:
            yield
            return
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        with self.prof:
            with torch.profiler.record_function(WINDOW):
                yield
            torch.cuda.synchronize()
        self.result = reduce(self.prof)
        self.prof = None

    def span(self, name: str):
        if not self.enabled:
            return contextlib.nullcontext()
        return torch.profiler.record_function("bench." + name)


def reduce(prof) -> Trace:
    """The window's Trace from the profiler's raw (kineto) events."""
    from torch.autograd import DeviceType

    device, spans, window = [], [], None
    for e in prof.profiler.kineto_results.events():
        name, a = e.name(), e.start_ns()
        b = a + e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            if not name.startswith("bench."):  # the spans' own marks on the device timeline
                device.append((name, a, b))
        elif name == WINDOW:
            window = (a, b)
        elif name.startswith("bench."):
            spans.append((name[6:], a, b))
    if window is None:
        raise RuntimeError("the trace holds no window span")
    t0, t1 = window
    # the device runs after the host queued it: the window ends with the last activity
    end = max([t1] + [b for _, _, b in device])
    clip = lambda xs: [(n, (max(a, t0) - t0) / 1e9, (min(b, end) - t0) / 1e9)
                       for n, a, b in xs if b > t0 and a < end]
    device, spans = clip(device), clip(spans)
    busy = sum(b - a for a, b in union(device))
    return Trace((end - t0) / 1e9, busy, device, spans)
