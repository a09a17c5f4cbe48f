"""K1's share of its roofline: the least time the card needs to gear-hash
every byte of the window's files and write both candidate bitmaps
(bounds.k1_bound_s), over the device time of K1's kernels in the trace."""

from benchmark import bounds

KERNELS = ("gear_bitmaps_kernel",)


def read(ctx):
    spent = ctx.trace.seconds_of(KERNELS) if ctx.trace is not None else None
    if not spent or not ctx.work["positions"]:
        return None
    return 100.0 * bounds.k1_bound_s(ctx.work["positions"]) / spent
