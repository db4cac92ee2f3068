"""Container (STGC, or STGV for a volume) bits per pixel over every
request of the window."""


def read(ctx):
    return 8.0 * sum(ctx.container_bytes) / sum(ctx.pixels) if ctx.pixels else None
