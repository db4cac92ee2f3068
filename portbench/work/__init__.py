"""Work counts of the kernel layer, from shapes and this input's plan.

A count is the bytes the work itself needs, whatever kernels carry it
out: each input byte read once and each output byte written once. It
does not change when a later change fuses, splits or replaces a kernel,
so a roofline share built on it compares across such changes.

* raster embed: the image read, the stego written, the ``s`` XOR planes
  written packed, the payload read packed;
* raster extract: the pixels of the plane windows read (their union), the
  payload written packed (the restore runs on the host);
* a PEE pass: the image read, its output written, its bits read packed
  (embed) or written packed (extract); the overflow map, one bit a pixel,
  written once by the embed and read once by the extract.

The plan comes from the container's header (``reference.stgc``): the
cut point, the plane windows, the passes and the bits of each.
"""

from __future__ import annotations

from ..reference import stgc

HBM_BYTES_PER_S = 3.35e12     # one NVIDIA H100 SXM (data sheet)
_ITEMSIZE = {1: 1, 2: 2}      # STGC dtype code -> bytes per pixel


def _packed(bits: int) -> int:
    return -(-int(bits) // 8)


def window_union(starts, lengths, n: int) -> int:
    """Pixels covered by the plane windows ``[start, start + length)``
    taken modulo ``n``."""
    spans = []
    for a, ln in zip(starts, lengths):
        ln = min(int(ln), n)
        a = int(a) % n
        if a + ln <= n:
            spans.append((a, a + ln))
        else:
            spans += [(a, n), (0, a + ln - n)]
    covered, end = 0, 0
    for a, b in sorted(spans):
        a = max(a, end)
        if b > a:
            covered += b - a
            end = b
    return covered


def raster_embed_bytes(n: int, itemsize: int, s: int, payload_bits: int) -> int:
    return 2 * n * itemsize + s * _packed(n) + _packed(payload_bits)


def raster_extract_bytes(n: int, itemsize: int, starts, lengths,
                         payload_bits: int) -> int:
    return window_union(starts, lengths, n) * itemsize + _packed(payload_bits)


def pee_bytes(n: int, itemsize: int, pass_bits) -> int:
    """One direction (embed or extract) of the passes with ``pass_bits``
    bits each, the overflow map once."""
    return sum(2 * n * itemsize + _packed(b) for b in pass_bits) + _packed(n)


def container_work(container: bytes) -> dict:
    """``{"embed": bytes, "extract": bytes}`` of one image's container."""
    h = stgc.parse_stgc(container)
    n, isz = h["width"] * h["height"], _ITEMSIZE[h["dtype_code"]]
    if h["strategy_id"] == stgc.STRATEGY_IDS["pee"]:
        _, passes, _, _, bits0, bits1 = stgc.pee_ext(h["ext"])
        pass_bits = (bits0, bits1)[:passes]
        return {"embed": pee_bytes(n, isz, pass_bits),
                "extract": pee_bytes(n, isz, pass_bits)}
    return {"embed": raster_embed_bytes(n, isz, h["s"], h["payload_bits"]),
            "extract": raster_extract_bytes(n, isz, h["plane_starts"],
                                            h["eff_lengths"],
                                            h["payload_bits"])}
