"""Seconds of ``Pack``'s ``scan`` stage per GiB of the window's layer tars:
the program's ``ntpu_pack_stage_seconds{stage="scan"}`` (converter/pack.py)
over the window's input bytes. The tar walk and metadata, less the
chunking and assembly timed inside it. Layers run side by side, so the
stage's seconds add up across them."""

STAGE = 'ntpu_pack_stage_seconds{stage="scan"}'


def read(ctx):
    seconds = ctx.counter(STAGE)
    if not seconds or not ctx.window_bytes:
        return None
    return seconds / (ctx.window_bytes / 2**30)
