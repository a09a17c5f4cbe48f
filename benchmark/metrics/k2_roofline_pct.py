"""K2's share of its roofline: the least time the card needs for the
SHA-256 of every chunk of the window (bounds.k2_bound_s over the reference's
chunk sizes), over the device time of K2's kernel in the trace. The serial
term of the longest chunk is not in it (printed apart)."""

from benchmark import bounds

KERNELS = ("sha256_chunks_kernel",)


def read(ctx):
    spent = ctx.trace.seconds_of(KERNELS) if ctx.trace is not None else None
    if not spent or not len(ctx.work["chunk_sizes"]):
        return None
    return 100.0 * bounds.k2_bound_s(ctx.work["chunk_sizes"]) / spent
