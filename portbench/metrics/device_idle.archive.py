"""Share of the traced window in which no operation ran on the device, %
(batch and volume cells)."""


def read(ctx):
    return ctx.idle_percent()
