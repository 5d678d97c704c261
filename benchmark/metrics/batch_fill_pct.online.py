"""Real rows over max_batch, over every batch the engine ran in the window
(the benchmark's wrappers of the engine's preprocessor and inference), in
the untraced window."""


def read(ctx):
    rows = ctx.record.get("batch_rows")
    if not rows:
        return None
    return 100.0 * sum(rows) / (len(rows) * ctx.record["max_batch"])
