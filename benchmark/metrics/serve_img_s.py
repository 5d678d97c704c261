"""Images whose detection lists reached the host, over the whole window."""


def read(ctx):
    r = ctx.record
    return r["images"] / r["window_s"] if r.get("window_s") else None
