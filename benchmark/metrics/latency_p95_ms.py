"""95th percentile, over every request of the window, of the time from its
due time to its answer (host clock)."""

from benchmark.readers import p95


def read(ctx):
    return p95(ctx.record.get("latency_ms", []))
