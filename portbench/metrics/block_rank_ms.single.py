"""The block fill's ranking per single-image request, ms: the program's
``block_rank`` stage walls (the encode's tile popcounts and ranking inside
``embed``, the decode's host popcounts and ranking inside ``extract``)."""


def read(ctx):
    return ctx.stage_ms(("block_rank",))
