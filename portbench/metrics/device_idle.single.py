"""Share of the traced window in which no operation ran on the device, %
(single-image cells)."""


def read(ctx):
    return ctx.idle_percent()
