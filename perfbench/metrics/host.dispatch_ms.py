"""Host milliseconds of each `detect` call the stream makes (the
benchmark's own span around the call), mean over the timed window."""


def read(ctx):
    s = ctx.spans.get("dispatch")
    return 1e3 * sum(s) / len(s) if s else None
