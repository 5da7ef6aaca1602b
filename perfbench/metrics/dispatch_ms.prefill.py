"""The host's time in the prefill step per request: from the step's call to
its return, with no sync, the mean over the untraced requests of the window
(the benchmark's own span around the call into the port's steps)."""


def read(ctx):
    if not ctx.untraced:
        return None
    return 1e3 * sum(d for _, _, _, d in ctx.untraced) / len(ctx.untraced)
