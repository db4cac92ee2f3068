# Port of codec_tcc_tpu/parallel/batch.py: hybrid_base_offsets_host only,
# the same code; only prose differs. The rest of batch.py (the raster batch
# encoder and decoder) is ROADMAP.md queue 1 item 6.
"""Host planning shared by the single-image and batch raster encoders."""

from __future__ import annotations

import numpy as np

__all__ = ["hybrid_base_offsets_host"]


def hybrid_base_offsets_host(
    images: np.ndarray, h: int, w: int, search_block: int
) -> list:
    """Pure-numpy twin of the device hybrid start scan
    (``ops.blocks.block_bit_counts`` of plane 0 +
    ``best_offset_from_counts``): plane-0 tile popcounts (zero-padded
    reshape-sum, the same zeros-contribute-nothing convention as
    ``ops.blocks.block_bit_counts_all``) + the exact integer-key ranking.
    Popcounts are integers, so the chosen offsets are identical to the
    device scan's, and the host route needs no image on the device."""
    from ..ops import blocks as block_ops

    b = images.shape[0]
    bs = search_block
    nh, nw = -(-h // bs), -(-w // bs)
    bits = (images & 1).astype(np.uint8)
    if (nh * bs, nw * bs) != (h, w):
        bits = np.pad(bits, ((0, 0), (0, nh * bs - h), (0, nw * bs - w)))
    counts = bits.reshape(b, nh, bs, nw, bs).sum(axis=(2, 4), dtype=np.int64)
    return [
        block_ops.best_offset_from_counts(counts[i], h, w, bs)
        for i in range(b)
    ]
