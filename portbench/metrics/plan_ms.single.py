"""Host planning per single-image request, ms: the program's
``decompose``, ``block_scan`` and ``pee_histogram`` stage walls (those
that ran)."""


def read(ctx):
    return ctx.stage_ms(("decompose", "block_scan", "pee_histogram"))
