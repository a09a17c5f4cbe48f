"""Seconds the interpreter's collector ran per GiB of the window's layer
tars: the program's ``ntpu_gc_pause_seconds{generation}`` summed over the
generations (metrics/gc_pauses.py), over the window's input bytes. The
pauses fall inside the other stages: a share of them, not a term beside
them."""

KEYS = tuple(f'ntpu_gc_pause_seconds{{generation="{g}"}}' for g in (0, 1, 2))


def read(ctx):
    found = [v for v in map(ctx.counter, KEYS) if v is not None]
    if not found or not sum(found) or not ctx.window_bytes:
        return None
    return sum(found) / (ctx.window_bytes / 2**30)
