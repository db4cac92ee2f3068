"""Host-device copies per single-image request, MB: the program's
``h2d_bytes`` and ``d2h_bytes`` counters over the window (the harness
zeroes them with the stage walls before it) per request. None where the
program has no counter registry."""

from codec_tcc_tpu_torch import profiling


def read(ctx):
    if not hasattr(profiling, "counters") or not ctx.requests:
        return None
    c = profiling.counters()
    return (c.get("h2d_bytes", 0) + c.get("d2h_bytes", 0)) / ctx.requests / 1e6
