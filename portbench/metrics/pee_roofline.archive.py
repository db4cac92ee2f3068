"""Share of its roofline that the batch K3/K4 reach, %: the work bytes of
the traced requests' slice containers (``portbench.work``, from each
container's plan: the count of ``embed_roofline.single``) over 3.35 TB/s,
divided by the device time of every kernel and memset launched inside the
program's ``batch_embed`` and ``batch_extract`` stage ranges. None where
those ranges hold no device time."""

from portbench.work import HBM_BYTES_PER_S


def read(ctx):
    if not ctx.trace or not ctx.work:
        return None
    dev = sum(ctx.trace["range_device_s"].get(k, 0.0)
              for k in ("batch_embed", "batch_extract"))
    if dev <= 0:
        return None
    return 100.0 * (ctx.work["embed"] + ctx.work["extract"]) / HBM_BYTES_PER_S / dev
