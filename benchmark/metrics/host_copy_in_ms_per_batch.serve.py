"""Host ms a batch of the port's copies in, over the untraced window: the
`stack` span (np.stack of the frames) and the `copy_in` spans of the
letterbox program and of the serving program (copies into their static
inputs), summed, over the `predict` spans (the port's ring,
cerberusdet_tpu_torch/utils/tracing.py)."""

from benchmark.ring import window


def read(ctx):
    w = window(ctx)
    if w is None:
        return None
    return w.host_ms_per(("stack", "copy_in"), ("preprocess", "predict"), "predict")
