"""Rows over the engine's `batch` spans times max_batch, over the batches
that began in the untraced window (each span's value is its rows; the
port's ring, cerberusdet_tpu_torch/utils/tracing.py)."""

from benchmark.ring import window


def read(ctx):
    w = window(ctx)
    if w is None or not ctx.traffic.get("max_batch"):
        return None
    return w.fill_pct("batch", int(ctx.traffic["max_batch"]))
