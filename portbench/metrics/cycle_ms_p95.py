"""95th percentile (nearest rank) of the wall times of the requests
completed in the window, ms."""

from portbench.stats import percentile


def read(ctx):
    return 1e3 * percentile(ctx.durations, 95) if ctx.durations else None
