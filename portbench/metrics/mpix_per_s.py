"""Pixels encoded and decoded (each counted once) over the window's
seconds, millions a second."""


def read(ctx):
    return sum(ctx.pixels) / ctx.window_s / 1e6 if ctx.durations else None
