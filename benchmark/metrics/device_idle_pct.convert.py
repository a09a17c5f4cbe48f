"""The share of the traced window in which no kernel, copy or set runs on
the card (the union of the trace's device intervals against the window)."""


def read(ctx):
    if ctx.trace is None or not ctx.window_s:
        return None
    return 100.0 * max(0.0, 1.0 - ctx.trace.busy_s() / ctx.window_s)
