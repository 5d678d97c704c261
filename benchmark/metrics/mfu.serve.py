"""The forward's operations (counted from shapes) over the window's rows at
the published peak of each conv's precision, as a share of the window (the
untraced one: host clock)."""

from benchmark.readers import serve_mfu


def read(ctx):
    return serve_mfu(ctx)
