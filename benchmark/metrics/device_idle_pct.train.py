"""Share of the traced window with no kernel, copy or set on the device
(profiler activity, benchmark/trace.py)."""

from benchmark.readers import idle_pct


def read(ctx):
    return idle_pct(ctx)
