"""Host ms a batch of `predict`'s work after the copy out, over the untraced
window: its `unpack` and `format` spans (the result unpacked, then the
detection dicts built), summed, over the `predict` spans (the port's ring,
cerberusdet_tpu_torch/utils/tracing.py)."""

from benchmark.ring import window


def read(ctx):
    w = window(ctx)
    return None if w is None else w.host_ms_per(("unpack", "format"), ("predict",), "predict")
