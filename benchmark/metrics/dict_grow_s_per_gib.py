"""Seconds of the batch's dict growth (``add_bootstrap_bytes``) per GiB of
the window's layer tars: the program's
``ntpu_batch_stage_seconds{stage="dict_grow"}`` (converter/batch.py) over
the window's input bytes. One term of the image's critical path."""

STAGE = 'ntpu_batch_stage_seconds{stage="dict_grow"}'


def read(ctx):
    seconds = ctx.counter(STAGE)
    if not seconds or not ctx.window_bytes:
        return None
    return seconds / (ctx.window_bytes / 2**30)
