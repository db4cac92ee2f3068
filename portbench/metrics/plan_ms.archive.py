"""Batch or volume planning per request, ms: the program's ``batch_plan``,
or ``volume_cut_point`` and ``volume_plan``, stage walls."""


def read(ctx):
    return ctx.stage_ms(("batch_plan", "volume_cut_point", "volume_plan"))
