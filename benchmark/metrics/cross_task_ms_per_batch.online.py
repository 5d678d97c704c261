"""Device ms a batch of the serving program's `cross_task` stage (the
concatenation of the tasks' detections and the suppression between tasks),
from the stage marks captured in the program, over the replays read of those
that `predict` launched in the untraced window and were to read (at most one
a tracing.READ_GAP_S); None where fewer than 90% of those were read (the
port's ring, cerberusdet_tpu_torch/utils/tracing.py)."""

from benchmark.ring import window


def read(ctx):
    w = window(ctx)
    return None if w is None else w.stage_ms_per_replay(("cross_task",), "predict")
