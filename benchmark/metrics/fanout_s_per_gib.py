"""Seconds of the batch's layer fan-out (the pool, from its start to the
last layer's return) per GiB of the window's layer tars: the program's
``ntpu_batch_stage_seconds{stage="fanout"}`` (converter/batch.py) over the
window's input bytes. Once an image, not summed over its layers: one term
of the image's critical path."""

STAGE = 'ntpu_batch_stage_seconds{stage="fanout"}'


def read(ctx):
    seconds = ctx.counter(STAGE)
    if not seconds or not ctx.window_bytes:
        return None
    return seconds / (ctx.window_bytes / 2**30)
