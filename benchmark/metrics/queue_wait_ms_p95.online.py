"""95th percentile over the window's requests of the start of the predict
call that carried the request minus its due time (the benchmark's wrappers),
in the untraced window, which the profiler does not slow."""

from benchmark.readers import p95


def read(ctx):
    return p95(ctx.record.get("queue_wait_ms", []))
