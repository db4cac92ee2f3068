"""The transport codec and container per single-image request, ms: the
program's ``transport_codec`` and ``transport_decode`` stage walls."""


def read(ctx):
    return ctx.stage_ms(("transport_codec", "transport_decode"))
