"""Process start to the first timed request or step (host clock)."""


def read(ctx):
    return ctx.record["setup_s"]
