"""The tiled PEE entry points' own host time per request, ms: the self
time (wall less the child spans') of the program's
``encode_array_tiled_pee`` and ``decode_container_tiled_pee`` spans over
the window. None where the program keeps no self time or no such span."""

from codec_tcc_tpu_torch import profiling

ENTRIES = ("encode_array_tiled_pee", "decode_container_tiled_pee")


def read(ctx):
    self_s = getattr(profiling.get_profiler(), "self_wall", None)
    if not self_s or not ctx.requests:
        return None
    ran = [self_s[n] for n in ENTRIES if n in self_s]
    return 1e3 * sum(ran) / ctx.requests if ran else None
