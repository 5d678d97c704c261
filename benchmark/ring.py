"""What the readers of the port's ring share (metrics/*.py whose source is a
program span or counter): the ring's records in the run's untraced window
(cerberusdet_tpu_torch/utils/tracing.py:window)."""

from __future__ import annotations


def window(ctx):
    """The window's records, or None for a program without the port's ring
    (nothing to read) or a record without a window."""
    try:
        from cerberusdet_tpu_torch.utils import tracing
    except ImportError:
        return None
    r = ctx.record
    if not r.get("window_s"):
        return None
    return tracing.window(r["t0"], r["window_s"])
