"""The share of the traced window in which nothing ran on the device."""


def read(ctx):
    if not ctx.summary.window_s:
        return None
    return 100 * (1 - ctx.summary.busy_s / ctx.summary.window_s)
