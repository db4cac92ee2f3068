"""Equal-T attempt groups of the PEE batch encoder per request: the
program's counter ``pee.batch_groups`` over the window (the harness zeroes
it with the stage walls before it) per request; each group is one K3
launch a pass. None where the program has no counter registry or no such
counter."""

from codec_tcc_tpu_torch import profiling


def read(ctx):
    if not hasattr(profiling, "counters") or not ctx.requests:
        return None
    groups = profiling.counters().get("pee.batch_groups")
    return None if groups is None else groups / ctx.requests
