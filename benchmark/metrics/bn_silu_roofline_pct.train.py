"""The BatchNorm + SiLU kernels' least time over their device time in the
traced window (bn_silu_ms_per_step.train's): the bytes of every training
BatchNorm + SiLU of the window's steps (work.bn_silu_bytes, each task's
forward on its own batch) at the published bandwidth."""

from benchmark import work as W
from benchmark.readers import bn_silu_seconds


def read(ctx):
    dev = bn_silu_seconds(ctx)
    if dev is None:
        return None
    cfg, b, size = ctx.config, ctx.traffic["batch"], ctx.traffic["img_size"]
    nbytes = sum(W.bn_silu_bytes(ctx.family.convs(cfg["model"], [t], [nc], size, size), b)
                 for t, nc in zip(cfg["tasks"], cfg["nc"]))
    return 100.0 * nbytes * ctx.traced["steps"] / W.PEAK_BYTES / dev
