"""The tiled PEE passes per request, ms: the program's ``band_pass`` stage
walls (each ``embed_pass_tiled`` call inside ``embed`` and each
``extract_pass_tiled`` call inside ``extract``: the band launches, the
halo and rank-prefix gathers and the pass's one download)."""


def read(ctx):
    return ctx.stage_ms(("band_pass",))
