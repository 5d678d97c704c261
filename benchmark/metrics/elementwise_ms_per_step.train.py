"""Device time a step of the kernels outside the conv / gemm and the port's
kernel categories (benchmark/trace.py's classifier: elementwise and other),
over the traced window's steps (the --trace 1 run's second window). The
recorded time is divided by the share of the TAL kernels' launches (counted
by the program) that the trace kept, so a dropped record does not lower it."""

from benchmark.trace import category


def read(ctx):
    t, r = ctx.trace, ctx.traced
    if t is None or not r or not r.get("steps"):
        return None
    names = t.by_name()
    ms = 1e3 * sum(s for name, (_, s) in names.items()
                   if category(name) in ("elementwise", "other"))
    seen = sum(n for name, (n, _) in names.items() if category(name) == "tal")
    counted = r.get("launches", {}).get("tal", 0)
    if seen and counted:
        ms /= min(1.0, seen / counted)
    return ms / r["steps"]
