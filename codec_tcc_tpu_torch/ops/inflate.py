"""The deflate codec's decode of a stego onto the card: a block-parallel
inflate of the level-1 ``Z_RLE`` stream as hand-written CUDA kernels
(``csrc/inflate.cu``), and the route that picks the card or the host.

Every stream that the ``deflate`` transport codec writes
(:class:`..io.codecs.DeflateCodec`, and :mod:`.deflate_rle` on the card)
is ``zlib.compressobj(1, DEFLATED, 15, 9, Z_RLE)`` of the image's bytes
(uint16 as its low-byte plane, then its high-byte plane: SDFL code 3;
uint8 as it is: code 1), and every match ``Z_RLE`` writes is at distance
1. A deflate block therefore depends on the blocks before it through two
things only: the bit offset where it starts, and the last byte they wrote
(which a block that opens with a match repeats). So the blocks of one
stream decode in parallel once their starts are known, and a start can be
found without decoding what comes before it, by testing every bit offset
for a dynamic Huffman header that is whole (the speculative parallel
inflate of rapidgzip, Knespel and Brunst, HPDC 2023). Four launches: the
scan tests every offset and keeps the candidates, the measure decodes
each candidate to its end code, the chain walks the blocks from the zlib
header (decoding fixed blocks, and dynamic ones no candidate covers,
itself) and checks BFINAL, the length and the trailer's place, and the
emit stores each block's bytes into the image's byte planes and checks
Adler-32. ``tests/torch_inflate_plain.py`` is their spec in NumPy.

The route depends on the stream alone. A payload the kernels do not take
(:func:`sdfl_fields`: SDFL code 2, a zlib header with a dictionary, a
pixel count past the codec's cap), another codec, or a CPU device goes to
the host codec. On the card the status word decides: :data:`OK` uses the
card's image; :data:`FOREIGN` (a distance other than 1, as zlib's default
strategy writes, or a Huffman code that zlib takes incomplete) goes to the
host codec; any other status marks a stream that zlib refuses too, so the
host codec is asked to raise its ``Invalid file:`` error, and where it
decodes the stream instead, the kernels are at fault and
:func:`transport_decode` raises. Counters: ``codec.inflate_device`` and
``codec.inflate_host`` (streams by the side that decoded them),
``inflate.blocks`` and ``inflate.serial_blocks`` (chain blocks, and those
no candidate covered) and ``launch.<kernel>`` per launch.
"""

from __future__ import annotations

import struct
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import profiling
from ..device import download, upload_bytes
from .kernel_library import check, library, stream_ptr

__all__ = [
    "KERNELS",
    "OK",
    "FOREIGN",
    "STATUS",
    "DeviceInflate",
    "device_route",
    "inflate_device",
    "limits",
    "sdfl_fields",
    "transport_decode",
]

KERNELS = ("inflate_scan", "inflate_measure", "inflate_chain", "inflate_emit")

# the status word the kernels leave (csrc/inflate.cu INF_*)
OK, BROKEN, FOREIGN, LENGTH, ADLER = 0, 2, 3, 4, 5
STATUS = {
    OK: "ok",
    BROKEN: "a block that does not decode",
    FOREIGN: "a distance other than 1, or a code zlib takes incomplete",
    LENGTH: "a length other than the header's",
    ADLER: "an Adler-32 other than the trailer's",
}

SDFL_HEADER = 13
MAX_STREAM = (1 << 28) - 1       # raw and compressed bytes the kernels take


def limits(nbytes: int, want: int) -> Tuple[int, int]:
    """The kernels' caps for a stream of ``nbytes`` bytes that inflates to
    ``want``: the candidates the measure takes (every zlib block but the
    last holds 32,767 symbols, so a few kilobytes of stream) and the chain
    blocks the emit takes. Past them the chain decodes, or emits, the
    blocks itself: slower, never refused."""
    return 256 + nbytes // 2048, 64 + want // 2048


def sdfl_fields(blob) -> Optional[Tuple[int, int, int]]:
    """``(code, h, w)`` of a deflate payload that the kernels take: SDFL
    code 1 or 3, a pixel count the codec accepts, at most
    :data:`MAX_STREAM` bytes each way, and a zlib header (deflate, a
    window of at most 32 KiB, no preset dictionary). None for any other
    blob, which the host codec decodes or refuses."""
    from ..io.codecs import MAX_DECODE_PIXELS

    if len(blob) < SDFL_HEADER + 2 or bytes(blob[:4]) != b"SDFL":
        return None
    code, h, w = struct.unpack(">BII", bytes(blob[4:SDFL_HEADER]))
    if code not in (1, 3) or not (0 < h and 0 < w
                                  and h * w <= MAX_DECODE_PIXELS):
        return None
    cmf, flg = blob[SDFL_HEADER], blob[SDFL_HEADER + 1]
    if (cmf & 0x0F) != 8 or (cmf >> 4) > 7 or (cmf << 8 | flg) % 31 \
            or flg & 0x20:
        return None
    if h * w * (2 if code == 3 else 1) > MAX_STREAM \
            or len(blob) - SDFL_HEADER > MAX_STREAM:
        return None
    return code, h, w


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------


class DeviceInflate(NamedTuple):
    status: int
    stego: Optional[torch.Tensor]    # (h, w) on the card where status is OK
    candidates: int
    blocks: int
    serial: int


def inflate_device(blob, dev: torch.device) -> DeviceInflate:
    """The kernels on a deflate payload that :func:`sdfl_fields` takes, on
    the current stream: the stream goes up from pinned memory, the four
    launches inflate it into a fresh image, and the status and counts
    come back (16 bytes). The image is the stego only where the status is
    :data:`OK`."""
    code, h, w = sdfl_fields(blob)
    item = 2 if code == 3 else 1
    nbytes = len(blob) - SDFL_HEADER
    words = upload_bytes(memoryview(blob)[SDFL_HEADER:], dev,
                         4 * ((nbytes + 3) // 4 + 2))
    stego = torch.empty((h, w), dtype=torch.uint16 if item == 2
                        else torch.uint8, device=dev)
    lib = library()
    size = lib.inflate_buffer_bytes(nbytes, h * w * item)
    buf = torch.empty(size, dtype=torch.uint8, device=dev)
    err = lib.inflate_sdfl(words.data_ptr(), nbytes, stego.data_ptr(), h * w,
                           item, buf.data_ptr(), size, stream_ptr(stego))
    check(lib, err, "inflate")
    for kernel in KERNELS:
        profiling.count("launch." + kernel)
    status, ncand, nblocks, nserial = (
        int(v) for v in download(buf[:16].view(torch.int32)))
    return DeviceInflate(status, stego if status == OK else None, ncand,
                         nblocks, nserial)


def device_route(codec, blob, dev: torch.device) -> bool:
    """Whether :func:`transport_decode` tries the kernels: the ``deflate``
    codec's payload of a kind they take (:func:`sdfl_fields`), on a CUDA
    device."""
    return (codec.name == "deflate" and torch.device(dev).type == "cuda"
            and sdfl_fields(blob) is not None)


def transport_decode(codec, blob, dev: torch.device
                     ) -> Tuple[np.ndarray, Optional[torch.Tensor]]:
    """``codec.decode(blob)``, and the same image on ``dev`` where the
    kernels decoded it (else None). A payload that :func:`device_route`
    takes is inflated on the card: status :data:`OK` gives the card's
    image, downloaded once for the host array; :data:`FOREIGN` and every
    other payload go to the host codec, which decodes or raises as it
    always has. Any other status marks a stream that zlib refuses too:
    the host codec raises its ``Invalid file:`` error, and where it
    decodes the stream instead, this raises ``RuntimeError``."""
    if device_route(codec, blob, dev):
        res = inflate_device(blob, dev)
        if res.status == OK:
            profiling.count("codec.inflate_device")
            profiling.count("inflate.blocks", res.blocks)
            profiling.count("inflate.serial_blocks", res.serial)
            return download(res.stego), res.stego
        if res.status != FOREIGN:
            profiling.count("codec.inflate_host")
            codec.decode(blob)
            raise RuntimeError(
                "the inflate kernels refused a deflate stream that host zlib "
                f"decodes: status {res.status} "
                f"({STATUS.get(res.status, 'unknown')})")
    if codec.name == "deflate":
        profiling.count("codec.inflate_host")
    return codec.decode(blob), None
