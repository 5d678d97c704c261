"""What the metric readers (metrics/<name>.py) share. A reader gets the run's
context: `record` (the driver's counts and times of the untraced window: the
host-clock metrics read it), `traced` and `trace` (the record of a --trace 1
run's second, profiled window and its trace.Trace: the trace-read metrics
read them; None otherwise), `work` (work.ConvWork of one image's forward,
counted by the model family), `family` (the cell's families/ module),
`precision` ("int8" or "bf16"), `traffic`, `config`."""

from __future__ import annotations

from typing import Optional

import numpy as np

from benchmark import work as W

# the port's BatchNorm + SiLU wrappers (ops/bn_cuda.py, counted by their
# `launches`) and the kernels each launches, by name fragment
BN_SILU_KERNELS = {"bn_stats": ("bn_silu_stats", "bn_silu_finalize"),
                   "bn_apply": ("bn_silu_apply",),
                   "bn_grad_reduce": ("bn_silu_grad_reduce", "bn_silu_grad_finalize"),
                   "bn_dx": ("bn_silu_dx",)}
CONV_KINDS = ("conv", "plain")  # the work kinds conv_roofline reads (work.ConvWork.kind)


def idle_pct(ctx) -> Optional[float]:
    """Share of the traced window in which no kernel, copy or set ran."""
    t = ctx.trace
    if t is None or t.window_s <= 0 or not t.device:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def p95(values) -> Optional[float]:
    return float(np.percentile(values, 95)) if len(values) else None


def serve_mfu(ctx) -> Optional[float]:
    """The forward's operations over the window's images at the peak of each
    conv's precision, as a share of the window: rows computed (padding rows
    too) times one image's work."""
    r = ctx.record
    if not r.get("rows") or not r.get("window_s"):
        return None
    return 100.0 * W.peak_seconds(ctx.work, ctx.precision, r["rows"]) / r["window_s"]


def conv_roofline(ctx) -> Optional[float]:
    """The least time of the convolutions the conv kernels implement, over the
    rows computed in the traced window, divided by those kernels' device time
    there.

    Only the work of the two kinds these kernels implement counts
    (CONV_KINDS): a family's other kinds (ConvWork.kind) have readers of
    their own. Their kernels leave the bf16 side's time too: a family may
    hold KERNEL_KINDS, {kernel name fragment: work kind}, and a kernel whose
    name holds a fragment of another kind is not counted, whatever its
    category.
    int8: the Convs (the Detect towers' last 1x1 stays bf16 and is left out on
    both sides) against conv_s8 + quant_pack_s8 + quant_s8. Each kernel's time
    is its mean recorded launch times the launches the program counted in the
    window, so a launch the profiler dropped neither lowers the time nor
    raises the share. bf16: every convolution against cuDNN's conv / gemm
    kernels and its layout transposes (nchwToNhwc, nhwcToNchw), whose
    launches the program does not count: their recorded time
    is divided by the share of NMS launches the trace kept (counted by the
    program), the same correction."""
    t, r = ctx.trace, ctx.traced
    if t is None or not r or not r.get("rows"):
        return None
    names = t.by_name()
    launches = r.get("launches", {})
    if ctx.precision == "int8":
        convs = [c for c in ctx.work if c.kind == "conv"]
        dev = 0.0
        for frag, counted in (("conv_s8_kernel", launches.get("conv_s8_kernel", 0)),
                              ("quant_pack", launches.get("quant_pack_s8", 0)),
                              ("quant_nchw_kernel", launches.get("quant_nchw_kernel", 0))):
            dev += counted_seconds(names, (frag,), counted)
    else:
        from benchmark.trace import category
        convs = [c for c in ctx.work if c.kind in CONV_KINDS]
        other = [f for f, k in getattr(ctx.family, "KERNEL_KINDS", {}).items()
                 if k not in CONV_KINDS]
        dev = sum(s for name, (_, s) in names.items()
                  if (category(name) == "conv / gemm" or "cudnn" in name)
                  and not any(f in name for f in other))
        nms_seen = sum(n for name, (n, _) in names.items() if "nms_kernel" in name)
        nms_counted = launches.get("nms_kernel", 0)
        if nms_seen and nms_counted:
            dev /= min(1.0, nms_seen / nms_counted)
    if dev <= 0:
        return None
    least = sum(W.least_seconds(c, ctx.precision, r["rows"]) for c in convs)
    return 100.0 * least / dev


def counted_seconds(names, frags, counted: int) -> float:
    """The device seconds of the kernels whose names hold one of `frags`: their
    mean recorded launch times the launches the program counted (at least
    those recorded), so that a launch the profiler dropped neither lowers
    the time nor raises a share; 0 where the trace holds none."""
    seen = [(n, s) for name, (n, s) in names.items() if any(f in name for f in frags)]
    n_seen, s_seen = sum(x[0] for x in seen), sum(x[1] for x in seen)
    return s_seen / n_seen * max(counted, n_seen) if n_seen else 0.0


def bn_silu_seconds(ctx) -> Optional[float]:
    """The BatchNorm + SiLU kernels' device seconds in the traced window, each
    wrapper's kernels counted by counted_seconds; None where the trace holds
    none of them (a step on the PyTorch route)."""
    t, r = ctx.trace, ctx.traced
    if t is None or not r or not r.get("steps"):
        return None
    names, launches = t.by_name(), r.get("launches", {})
    dev = sum(counted_seconds(names, frags, launches.get(w, 0))
              for w, frags in BN_SILU_KERNELS.items())
    return dev or None
