"""The transport codec and container per batch or volume request, ms: the
program's ``batch_pack`` or ``volume_pack`` and ``batch_codec_decode``
stage walls."""


def read(ctx):
    return ctx.stage_ms(("batch_pack", "volume_pack", "batch_codec_decode"))
