"""Training images (all tasks) stepped over the whole window, which ends when
the device has finished the last step."""


def read(ctx):
    r = ctx.record
    return r["images"] / r["window_s"] if r.get("window_s") else None
