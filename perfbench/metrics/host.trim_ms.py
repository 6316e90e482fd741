"""Host milliseconds of each `BatchResults.trim()`, timed after the batch's
completion event has been waited on, so the wait is not counted; mean over
the timed window of the traced run."""


def read(ctx):
    s = ctx.spans.get("trim")
    return 1e3 * sum(s) / len(s) if s else None
