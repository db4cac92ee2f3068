"""Band launches of K3 and K4 per request: the program's counters
``launch.pee_count_band``, ``launch.pee_embed_band``,
``launch.pee_extract_count_band`` and ``launch.pee_extract_band`` over the
window (the harness zeroes them with the stage walls before it) per
request; 0 where the bands ran their plain versions on the CPU. None
where the program has no counter registry."""

from codec_tcc_tpu_torch import profiling

KERNELS = ("pee_count_band", "pee_embed_band", "pee_extract_count_band",
           "pee_extract_band")


def read(ctx):
    if not hasattr(profiling, "counters") or not ctx.requests:
        return None
    c = profiling.counters()
    return sum(c.get("launch." + k, 0) for k in KERNELS) / ctx.requests
