"""Share of its roofline that the block embed reaches, %: the traced
requests' embed work bytes (``portbench.work``: for a block container the
raster embed's, the image read, the stego written, the ``s`` XOR planes
written packed and the payload read packed) over 3.35 TB/s, divided by the
device time of every kernel and memset launched inside the program's
``embed`` stage ranges. The block extract runs on the host, so no extract
work or time is counted."""

from portbench.work import HBM_BYTES_PER_S


def read(ctx):
    if not ctx.trace or not ctx.work:
        return None
    dev = ctx.trace["range_device_s"].get("embed", 0.0)
    if dev <= 0:
        return None
    return 100.0 * ctx.work["embed"] / HBM_BYTES_PER_S / dev
