"""Plain NumPy reference of strategy ``block_adaptive`` for one image: the
upstream's strategy 2 (``src/codec.py:320-410``, a no-op there, bug B2)
with the semantics it was written for, from the scheme's description:

* the cut point ``s`` from the float64 MI replay, and the payload split
  over the planes below it, as for the raster strategies
  (``raster.cut_point``, ``raster.distribute_segments``);
* for each plane ``p < s``: the original's bit ``p`` summed over ``block x
  block`` tiles in raster order (edge tiles smaller); a tile of ``k``
  pixels with ``c`` ones has the binary variance ``c (k - c) / k**2``;
* the tiles ranked by that variance, highest first, ties in raster order;
  the variances are compared exactly, as Python integers over one common
  denominator;
* a pixel's fill rank is the summed sizes of the tiles ranked before its
  tile, plus its raster position inside the tile; bit ``i`` of the plane's
  segment goes to the pixel of fill rank ``i``;
* planes at and above ``s`` untouched; the maps are ``orig ^ stego`` of the
  planes below ``s``, bit-packed where the pixel count is a multiple of 8
  (STGC v2.1), one byte a bit otherwise;
* the container's extension block is ``>I block_size``; plane windows start
  at 0, aligned.

Nothing here imports the program or JAX.
"""

from __future__ import annotations

import math
import struct

import numpy as np

from . import raster, stgc


def tile_grid(h: int, w: int, block: int):
    """``(tile, pos, sizes)``: each pixel's raster tile index and its raster
    position inside that tile (both flat, raster order), and each tile's
    pixel count."""
    y = np.arange(h, dtype=np.int64)[:, None]
    x = np.arange(w, dtype=np.int64)[None, :]
    nw = -(-w // block)
    ty, tx = y // block, x // block
    tile_w = np.minimum(block, w - tx * block)
    tile = (ty * nw + tx).ravel()
    pos = ((y - ty * block) * tile_w + (x - tx * block)).ravel()
    ntiles = -(-h // block) * nw
    return tile, pos, np.bincount(tile, minlength=ntiles)


def variance_keys(ones: np.ndarray, sizes: np.ndarray) -> list:
    """Each tile's ``c (k - c) / k**2`` as a Python integer numerator over
    the product of the distinct ``k**2``: equal variances give equal keys
    and the order is the rationals' order."""
    denom = math.prod(int(k) ** 2 for k in np.unique(sizes))
    return [c * (k - c) * (denom // (k * k))
            for c, k in zip(ones.tolist(), sizes.tolist())]


def tile_order(keys: list) -> list:
    """Tile indices by key, highest first, ties in raster order."""
    return sorted(range(len(keys)), key=lambda t: (-keys[t], t))


def fill_ranks(plane_bits: np.ndarray, tile: np.ndarray, pos: np.ndarray,
               sizes: np.ndarray) -> np.ndarray:
    """Each pixel's fill rank in one plane whose bits (flat, 0/1) rank the
    tiles."""
    ones = np.bincount(tile[plane_bits == 1], minlength=sizes.size)
    order = np.asarray(tile_order(variance_keys(ones, sizes)), np.int64)
    first = np.empty(sizes.size, np.int64)
    first[order] = np.cumsum(sizes[order]) - sizes[order]
    return first[tile] + pos


def embed(image: np.ndarray, bits: np.ndarray, s: int, block: int,
          seed: int) -> dict:
    """One image's block fill at cut point ``s``: the plan's container
    fields, the stego and the maps."""
    h, w = image.shape
    n = h * w
    sizes, indices, offsets, eff = raster.distribute_segments(
        s, int(bits.size), seed)
    tile, pos, tile_sizes = tile_grid(h, w, block)
    flat = image.ravel()
    out = flat.copy()
    lengths = [0] * s
    for k, plane in enumerate(indices):
        num = min(eff[k], n)
        lengths[plane] = num
        one = flat.dtype.type(1 << plane)
        rank = fill_ranks((flat >> flat.dtype.type(plane)) & 1, tile, pos,
                          tile_sizes)
        sel = rank < num
        seg = bits[offsets[k] + rank[sel]].astype(flat.dtype)
        out[sel] = (out[sel] & ~one) | (seg << flat.dtype.type(plane))
    stego = out.reshape(h, w)
    diff = flat ^ out
    planes = np.stack([((diff >> p) & 1).astype(np.uint8) for p in range(s)]
                      ) if s else np.zeros((0, n), np.uint8)
    maps = np.packbits(planes, axis=1) if n % 8 == 0 else planes
    return {"s": s, "start_offset": 0, "sizes": tuple(sizes),
            "indices": tuple(indices), "eff_lengths": tuple(lengths),
            "plane_starts": (0,) * s, "stego": stego, "maps": maps}


def encode_image(image: np.ndarray, bits: np.ndarray, cfg: dict,
                 device=None) -> dict:
    """What one image's block_adaptive encode must give: ``header`` fields,
    ``stego``, the ``maps`` and float64 ``metrics`` (NumPy on the host:
    ``device`` is not used)."""
    nbits = min(cfg["bits_stored"], image.dtype.itemsize * 8)
    s = raster.cut_point(image, cfg["beta"], nbits)
    block = int(cfg["block_size"])
    e = embed(image, bits, s, block, cfg["seed"])
    head = raster.header(e, cfg, image, int(bits.size), nbits, True)
    if image.size % 8:
        head["flags"] &= ~stgc.FLAG_PACKED
    head["ext"] = struct.pack(">I", block)
    return {"header": head, "stego": e["stego"], "maps": e["maps"],
            "metrics": raster.quality(image, e["stego"])}
