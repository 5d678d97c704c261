"""A step's operations, three times each task's forward (counted from shapes:
the forward, the two products of the backward, no recompute), over the
window at the bf16 peak, as a share of the window (the untraced one: host
clock); the forward's work as the model family counts it."""

from benchmark import work as W


def read(ctx):
    r, cfg = ctx.record, ctx.config
    if not r.get("steps") or not r.get("window_s"):
        return None
    b, size = ctx.traffic["batch"], ctx.traffic["img_size"]
    ops = sum(W.forward_ops(ctx.family.convs(cfg["model"], [t], [nc], size, size))
              for t, nc in zip(cfg["tasks"], cfg["nc"]))
    return 100.0 * 3.0 * ops * b * r["steps"] / W.PEAK_OPS["bf16"] / r["window_s"]
