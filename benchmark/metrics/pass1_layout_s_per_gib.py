"""Seconds of the fused lane's ``pass1_layout`` stage per GiB it processed,
over the window: the program's
``ntpu_fused_convert_stage_seconds{stage="pass1_layout"}`` over
``ntpu_fused_convert_bytes`` (ops/fused_convert.py). Pass 1's layout of a
layer's files in one host buffer. Layers run side by side, so the stage's
seconds add up across them."""

STAGE = 'ntpu_fused_convert_stage_seconds{stage="pass1_layout"}'
BYTES = "ntpu_fused_convert_bytes"


def read(ctx):
    seconds, nbytes = ctx.counter(STAGE), ctx.counter(BYTES)
    if not seconds or not nbytes:
        return None
    return seconds / (nbytes / 2**30)
