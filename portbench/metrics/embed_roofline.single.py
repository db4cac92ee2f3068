"""Share of its roofline that the kernel layer reaches, %: the work bytes
of the traced requests' embed and extract (``portbench.work``, from
shapes and each container's plan) over 3.35 TB/s, divided by the device
time of every kernel and memset launched inside the program's ``embed``
and ``extract`` stage ranges."""

from portbench.work import HBM_BYTES_PER_S


def read(ctx):
    if not ctx.trace or not ctx.work:
        return None
    dev = sum(ctx.trace["range_device_s"].get(k, 0.0)
              for k in ("embed", "extract"))
    if dev <= 0:
        return None
    return 100.0 * (ctx.work["embed"] + ctx.work["extract"]) / HBM_BYTES_PER_S / dev
