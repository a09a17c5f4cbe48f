"""K4's share of its roofline: the least time the card needs for the BLAKE3
of every chunk of the window (bounds.k4_bound_s over the reference's chunk
sizes), over the device time of K4's leaf and tree kernels in the trace. The
serial term is not in it (printed apart)."""

from benchmark import bounds

KERNELS = ("blake3_leaves", "blake3_parents")


def read(ctx):
    spent = ctx.trace.seconds_of(KERNELS) if ctx.trace is not None else None
    if not spent or not len(ctx.work["chunk_sizes"]):
        return None
    return 100.0 * bounds.k4_bound_s(ctx.work["chunk_sizes"]) / spent
