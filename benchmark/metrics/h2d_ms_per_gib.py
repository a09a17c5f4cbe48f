"""Milliseconds of host-to-device copies on the card per GiB of layer tars
converted in the window (the fused pass uploads each layer's files)."""


def read(ctx):
    if ctx.trace is None or not ctx.window_bytes:
        return None
    copies = ctx.trace.copies("HtoD")
    if not copies:
        return None
    return 1e3 * sum(c.seconds for c in copies) / (ctx.window_bytes / 2**30)
