"""95th percentile over the requests the engine took in the untraced window
of their `queue` spans: submit to the start of their batch's preprocess (the
port's ring, cerberusdet_tpu_torch/utils/tracing.py)."""

from benchmark.ring import window


def read(ctx):
    w = window(ctx)
    return None if w is None else w.percentile(("queue",), 95)
