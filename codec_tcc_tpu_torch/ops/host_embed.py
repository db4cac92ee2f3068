# Port of codec_tcc_tpu/ops/host_embed.py: the same code; only import lines and prose differ.
"""O(payload) host embed of the raster strategies (numpy only).

The raster strategies place message bits into each plane's raster window
``[start_p, start_p + len_p) mod N``: pure bit placement, no per-pixel
arithmetic. This is the window-sliced host form that ``device_policy``
routes raster encodes through (``EncodeConfig.resolve_host_route``:
``"host"``, or ``"auto"`` with no metrics asked for): the bit-packed XOR
maps are built straight from the message and the original's plane bits
inside each window (everything outside a window is zero by construction),
and the stego is rebuilt with the same O(payload) window XOR the decode
side uses. The image is never uploaded.

Bit-exact with the device route (kernel K1): containers are byte-identical
(``tests/test_torch_host_route.py``).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from ..utils import bits as bit_utils

__all__ = ["embed_raster_host_packed"]


def embed_raster_host_packed(
    image: np.ndarray,
    msg_bits: np.ndarray,
    starts,
    lengths,
    offsets,
    s: int,
    max_s: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Embed ``msg_bits`` into ``image``'s raster windows; return
    ``(stego, packed_maps)`` where ``packed_maps`` is the ``(max_s, N//8)``
    uint8 bit-packed XOR location maps (identical bytes to the device
    route's ``xor_maps_packed_batch`` — they become the v2.1 container
    bitmap blobs as-is).

    Semantics matched to ``ops.embed.embed``'s active mask: plane ``p``
    embeds ``msg_bits[offsets[p] + r]`` at raster position
    ``(starts[p] + r) mod N`` for ``r < min(lengths[p], N)``; planes at or
    past the cut point ``s`` embed nothing. The XOR map bit is
    ``orig_bit ^ msg_bit`` inside the window, zero elsewhere — so only the
    window-covering bytes are ever written (two spans when the hybrid
    window wraps, the shared boundary byte OR-accumulated: within one
    plane the wrapped spans cover disjoint BIT ranges)."""
    h, w = image.shape
    n = h * w
    if n % 8:
        raise ValueError("embed_raster_host_packed needs N % 8 == 0")
    flat = image.reshape(-1)
    packed = np.zeros((max_s, n // 8), dtype=np.uint8)
    for p in range(min(int(s), max_s)):
        raw_spans = bit_utils.raster_window_spans(starts[p], lengths[p], n)
        if not raw_spans:
            continue
        start = int(starts[p]) % n
        off = int(offsets[p])
        # annotate each span with where its bits sit in the message: the
        # wrap span continues after the first span's (n - start) bits
        spans = [
            (a, b, off if a == start else off + (n - start))
            for a, b in raw_spans
        ]
        for a, b, ma in spans:
            b0 = a // 8
            b1 = (b + 7) // 8
            width = 8 * (b1 - b0)
            seg = np.zeros(width, dtype=np.uint8)
            lo = a - 8 * b0
            count = b - a
            mseg = msg_bits[ma : ma + count]
            if mseg.shape[0] < count:  # plan guarantees coverage; stay safe
                mseg = np.concatenate(
                    [mseg, np.zeros(count - mseg.shape[0], np.uint8)]
                )
            orig = (flat[8 * b0 + lo : 8 * b0 + lo + count] >> p) & 1
            seg[lo : lo + count] = mseg ^ orig.astype(np.uint8)
            np.bitwise_or(
                packed[p, b0:b1], np.packbits(seg), out=packed[p, b0:b1]
            )
    stego = bit_utils.xor_packed_windows(image, packed, starts, lengths)
    return stego, packed
