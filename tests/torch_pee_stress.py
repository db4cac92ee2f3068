"""Stress cases for the cross-tile rank of K3 ``pee_embed`` (its decoupled
look-back), shared by ``chip_smoke.py`` (phase 2), ``tests/test_torch_cuda.py``
and the CPU test that holds them against the JAX package.

Each case is a batch of seeded carriers (numpy) and a list of per-image
``want`` vectors that put the end of the processed prefix where the rank
is easiest to get wrong: 0 and 1, ``cap`` and ``cap + 1`` (saturation),
far past ``cap``, and the eligible count at a tile boundary and one either
side of it. The geometries cover several tiles per image in narrow images
(``w`` = 3 and 5), a row longer than a tile (3 x 20,000), ``H*W`` that is not
a multiple of the 16-byte vector (500x501 u8, so image ``b`` starts
unaligned) and, in :data:`MANY_TILES`, far more tiles than the card holds
at once.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from codec_tcc_tpu_torch.ops import pee as pee_ops

# name, batch, height, width, dtype, max_val
SHAPES = (
    ("tiles512_u16", 3, 512, 512, "uint16", 4095),
    ("narrow_w3_u16", 3, 3000, 3, "uint16", 4095),
    ("narrow_w5_u8", 3, 2000, 5, "uint8", 255),
    ("wide_3x20000_u16", 3, 3, 20000, "uint16", 4095),
    ("odd500x501_u8", 3, 500, 501, "uint8", 255),
)
# a launch of 8 x 1,024 tiles of 4,096 pixels: most start only after others
# have finished, so the look-back waits on tiles that started late
MANY_TILES = ("many_8x2048x2048_u16", 8, 2048, 2048, "uint16", 4095)
T_VALUES = (2, 47)


def carriers(rng, b: int, h: int, w: int, dtype, hi: int) -> np.ndarray:
    """Smooth gradients with small noise, one row at ``hi`` and one column
    at 0: expandable, shifted and overflow pixels in one image."""
    y, x = np.mgrid[0:h, 0:w]
    base = (x + 2 * y) / (w + 2 * h) * hi
    imgs = np.clip(base[None] + rng.normal(0, 2.0, (b, h, w)), 0, hi)
    imgs = imgs.astype(dtype)
    imgs[:, h // 3, :] = hi
    imgs[:, :, w // 4] = 0
    return imgs


def inputs(shape, seed: int = 4) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``(imgs (B, H, W), msg (B, H*W // 2 + 1) uint8 bits, msg_base (B,)
    int32)`` of one entry of :data:`SHAPES`."""
    _, b, h, w, dtype, hi = shape
    rng = np.random.default_rng(seed + h * w)
    imgs = carriers(rng, b, h, w, np.dtype(dtype), hi)
    msg = rng.integers(0, 2, (b, h * w // 2 + 1)).astype(np.uint8)
    base = np.arange(b, dtype=np.int32) * 7
    return imgs, msg, base


def wants(imgs: torch.Tensor, parity: int, t: int, max_val: int,
          tile_px: int) -> List[Tuple[str, torch.Tensor]]:
    """``(label, want (B,) int32)`` pairs for one pass over ``imgs``, from
    the plain version's eligible mask; boundaries are those of
    ``tile_px``-pixel tiles (K3's tile on the card)."""
    b, h, w = imgs.shape
    _, _, in_set, expandable, overflow = pee_ops._classify(imgs, parity, t,
                                                           max_val)
    cum = torch.cumsum((in_set & expandable & ~overflow).reshape(b, h * w), 1,
                       dtype=torch.int32)
    cap = cum[:, -1]
    out = [("0", torch.zeros_like(cap)), ("1", torch.ones_like(cap)),
           ("cap", cap), ("cap+1", cap + 1),
           ("2**30", torch.full_like(cap, 1 << 30))]
    tiles = -(-(h * w) // tile_px)
    for k in sorted({1, tiles // 2, tiles - 1}):
        if 1 <= k < tiles:
            at = cum[:, k * tile_px - 1]
            for d in (-1, 0, 1):
                out.append((f"tile{k}{d:+d}", (at + d).clamp(min=0)))
    return [(label, v.to(torch.int32).to(imgs.device)) for label, v in out]
