"""Device ms a step of the `clip` (the scaling by serving count and the
clipping), `optimizer` and `ema` stages, from the stage marks captured in
the train step, over the replays read of those that `train.step` launched in
the untraced window and were to read (at most one a tracing.READ_GAP_S);
None where fewer than 90% of those were read (the port's ring,
cerberusdet_tpu_torch/utils/tracing.py)."""

from benchmark.ring import window


def read(ctx):
    w = window(ctx)
    if w is None:
        return None
    return w.stage_ms_per_replay(("clip", "optimizer", "ema"), "train.step")
