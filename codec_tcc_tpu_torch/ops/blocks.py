# Port of codec_tcc_tpu/ops/blocks.py: the tile popcounts in torch on the
# image's device; the exact host ranking below them is the same code.
"""Block texture statistics: device popcounts + exact host ranking.

The reference scores ``block_size^2`` tiles of a bit plane by ``np.var``
(``src/codec.py:352-359`` for the adaptive strategy, ``:441-450`` for the
hybrid start-block search). For binary data the variance is the exact
rational ``c*(k-c)/k^2`` where ``c`` is the tile popcount and ``k`` the tile
size, so the device computes one integer popcount per tile (a reshape-sum —
no float at all) and the host ranks tiles with exact common-denominator
integer keys.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "block_bit_counts",
    "block_bit_counts_all",
    "ranking_from_counts",
    "best_offset_from_counts",
    "block_base_offsets",
]


def block_bit_counts(image: torch.Tensor, plane: int, block: int) -> torch.Tensor:
    """Popcount of bit ``plane`` per ``block x block`` tile.

    ``(H, W) -> (ceil(H/b), ceil(W/b)) int32``. The image is zero-padded to
    tile multiples; zeros contribute nothing to popcounts, and edge-tile sizes
    are recovered on host from the true dims.
    """
    return block_bit_counts_all(image, plane + 1, block)[plane]


def block_bit_counts_all(
    image: torch.Tensor, nplanes: int, block: int
) -> torch.Tensor:
    """Tile popcounts for planes ``0..nplanes-1`` in one pass:
    ``(H, W) -> (nplanes, ceil(H/b), ceil(W/b)) int32``, or for a batch
    ``(B, H, W) -> (B, nplanes, ...)``, on the image's device (``uint16``
    widened to ``int32``: torch has no shift for it)."""
    *lead, h, w = image.shape
    nh = -(-h // block)
    nw = -(-w // block)
    shifts = torch.arange(nplanes, dtype=torch.int32, device=image.device)
    bits = (image.to(torch.int32)[..., None, :, :]
            >> shifts.view(nplanes, 1, 1)) & 1
    padded = torch.zeros(
        (*lead, nplanes, nh * block, nw * block), dtype=torch.int32,
        device=image.device,
    )
    padded[..., :h, :w] = bits
    return (
        padded.view(*lead, nplanes, nh, block, nw, block)
        .sum(dim=(-3, -1), dtype=torch.int32)
    )


def _tile_dims(h: int, w: int, block: int) -> Tuple[np.ndarray, np.ndarray]:
    """(bh, bw) arrays over the raster-ordered tile grid (edge tiles smaller)."""
    ys = np.arange(0, h, block)
    xs = np.arange(0, w, block)
    bh = np.minimum(block, h - ys)
    bw = np.minimum(block, w - xs)
    return bh[:, None] * np.ones_like(bw)[None, :], np.ones_like(bh)[:, None] * bw[None, :]


def _int_keys(counts: np.ndarray, h: int, w: int, block: int) -> Sequence[int]:
    """EXACT integer sort keys proportional to the binary-variance scores
    ``c*(k-c)/k^2``: key_i = ``n_i * (M / k_i^2)`` with ``n = c*(k-c)`` and
    ``M = lcm`` of the (at most 4: interior / right edge / bottom edge /
    corner) distinct ``k^2`` values — the ordering is identical to comparing
    the rationals, with none of ``fractions.Fraction``'s per-element gcd
    normalization. The common every-tile-full case
    collapses to the raw int64 popcount products."""
    bh, bw = _tile_dims(h, w, block)
    k = (bh * bw).ravel().astype(np.int64)
    c = np.asarray(counts, dtype=np.int64).ravel()
    n = c * (k - c)                       # <= k^2/4, fits int64 for any image
    uniq = [int(v) for v in np.unique(k)]
    if len(uniq) == 1:
        return n                          # same denominator everywhere
    m = math.lcm(*[v * v for v in uniq])
    mult = {v: m // (v * v) for v in uniq}
    if m <= (1 << 62) // max(1, int(n.max())):
        lut = np.zeros(int(k.max()) + 1, dtype=np.int64)
        for v, f in mult.items():
            lut[v] = f
        return n * lut[k]                 # products proven to fit int64
    # arbitrary-precision fallback (enormous blocks): plain Python ints
    return [int(ni) * mult[int(ki)] for ni, ki in zip(n, k)]


def ranking_from_counts(counts: np.ndarray, h: int, w: int, block: int) -> List[int]:
    """Raster tile indices ranked by exact variance descending, raster ties."""
    keys = _int_keys(counts, h, w, block)
    if isinstance(keys, np.ndarray):
        # stable mergesort on -keys == variance desc with raster tie-breaks
        return list(np.argsort(-keys, kind="stable"))
    return sorted(range(len(keys)), key=lambda i: (-keys[i], i))


def best_offset_from_counts(counts: np.ndarray, h: int, w: int, block: int) -> int:
    """Raster pixel offset of the first strictly-max-variance tile — the
    hybrid strategy's start point (strict ``>`` scan, src/codec.py:441-450)."""
    keys = _int_keys(counts, h, w, block)
    if isinstance(keys, np.ndarray):
        best_i = int(np.argmax(keys))     # argmax returns the FIRST maximum
    else:
        best_i = max(range(len(keys)), key=lambda i: (keys[i], -i))
    nw = -(-w // block)
    y0 = (best_i // nw) * block
    x0 = (best_i % nw) * block
    return y0 * w + x0


def block_base_offsets(
    counts: np.ndarray, h: int, w: int, block: int
) -> Tuple[np.ndarray, List[int]]:
    """For the block-adaptive strategy: per-tile base offsets into the
    variance-ranked fill order.

    Returns ``(base[ntiles] int64 indexed by raster tile id, ranking)`` where a
    pixel at within-tile raster position ``r`` in tile ``t`` receives fill rank
    ``base[t] + r``.
    """
    ranking = ranking_from_counts(counts, h, w, block)
    bh, bw = _tile_dims(h, w, block)
    sizes = (bh * bw).ravel()
    base = np.zeros(len(ranking), dtype=np.int64)
    acc = 0
    for t in ranking:
        base[t] = acc
        acc += int(sizes[t])
    return base, ranking
