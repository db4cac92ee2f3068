"""Median wall time of the requests completed in the window, ms."""

from statistics import median


def read(ctx):
    return 1e3 * median(ctx.durations) if ctx.durations else None
