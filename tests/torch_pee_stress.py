"""Stress cases for the cross-tile rank of the PEE kernels (their decoupled
look-back): K3 ``pee_embed`` and K4 ``pee_extract``, shared by
``chip_smoke.py`` (phase 2), ``tests/test_torch_cuda.py`` and the CPU tests
that hold them against the JAX package.

Each case is a batch of seeded carriers (numpy) and a list of per-image
``want`` vectors that put the end of K3's processed prefix where the rank
is easiest to get wrong: 0 and 1, ``cap`` and ``cap + 1`` (saturation),
far past ``cap``, and the eligible count at a tile boundary and one either
side of it. K4 inverts each of K3's outputs; on the carrier at ``cap`` it
also runs with the ``out_len`` and ``nproc`` values of
:func:`extract_cases`, and on forged inputs (:func:`forged`: noisy stego,
random overflow bytes) with ``nproc`` at the set ranks that straddle its
tile boundaries (:func:`set_rank_nprocs`). The geometries cover several
tiles per image in narrow images (``w`` = 3 and 5), a row longer than a
tile (3 x 20,000), ``H*W`` that is not a multiple of the 16-byte vector
(500x501 u8, so image ``b`` starts unaligned) and, in :data:`MANY_TILES`,
far more tiles than the card holds at once.
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
    ``tile_px``-pixel tiles (the kernels' tile on the card)."""
    b, h, w = imgs.shape
    _, _, in_set, expandable, overflow = pee_ops._classify(imgs, parity, t,
                                                           max_val)
    cum = torch.cumsum((in_set & expandable & ~overflow).reshape(b, h * w), 1,
                       dtype=torch.int32)
    cap = cum[:, -1]
    out = [("0", torch.zeros_like(cap)), ("1", torch.ones_like(cap)),
           ("cap", cap), ("cap+1", cap + 1),
           ("2**30", torch.full_like(cap, 1 << 30))]
    for k in _tile_ends(h, w, tile_px):
        at = cum[:, k * tile_px - 1]
        for d in (-1, 0, 1):
            out.append((f"tile{k}{d:+d}", (at + d).clamp(min=0)))
    return [(label, v.to(torch.int32).to(imgs.device)) for label, v in out]


def _tile_ends(h: int, w: int, tile_px: int) -> List[int]:
    """The tiles whose first pixel is a stress boundary: the second, the
    middle and the last tile of an image."""
    tiles = -(-(h * w) // tile_px)
    return [k for k in sorted({1, tiles // 2, tiles - 1}) if 1 <= k < tiles]


def extract_cases(want_cases, nbits: torch.Tensor, nproc: torch.Tensor,
                  h: int, w: int) -> List[Tuple[str, torch.Tensor, int]]:
    """``(label, nproc (B,) int32, out_len)`` for K4 on K3's output at want
    ``cap``, whose expanded count is ``nbits`` (K3's ``used``) and whose
    boundary is ``nproc``: with that boundary, ``out_len`` at 1, 8, image
    0's expanded count at each tile boundary of ``want_cases`` (the
    ``tile*`` wants, one either side included), ``nbits`` and ``nbits + 1``;
    then all bits (``out_len = H*W // 2 + 1``) at ``nproc`` = 0, 1, ``H*W``,
    ``2**31 - 1`` and -5."""
    n0 = int(nbits[0])
    lens = [("1", 1), ("8", 8), ("nbits", n0), ("nbits+1", n0 + 1)]
    lens += [(label, int(v[0])) for label, v in want_cases
             if label.startswith("tile")]
    out = [(f"out_len={label}", nproc, max(v, 1)) for label, v in lens]
    for label, v in (("0", 0), ("1", 1), ("H*W", h * w),
                     ("2**31-1", 2**31 - 1), ("-5", -5)):
        out.append((f"nproc={label}", torch.full_like(nproc, v),
                    h * w // 2 + 1))
    return out


def forged(shape, t: int, seed: int = 5) -> Tuple[np.ndarray, np.ndarray]:
    """``(stego, overflow u8)`` that no encoder wrote, for one entry of
    :data:`SHAPES`: the carriers plus uniform noise in ``[-3t, 3t]`` (a mix
    of expanded and shifted pixels), and a random fifth of the overflow
    bytes set to random nonzero values."""
    _, b, h, w, dtype, hi = shape
    rng = np.random.default_rng(seed + h * w + t)
    imgs = carriers(rng, b, h, w, np.dtype(dtype), hi).astype(np.int64)
    imgs += rng.integers(-3 * t, 3 * t + 1, imgs.shape)
    over = rng.integers(1, 256, (b, h, w)) * (rng.random((b, h, w)) < 0.2)
    return np.clip(imgs, 0, hi).astype(dtype), over.astype(np.uint8)


def set_rank_nprocs(h: int, w: int, parity: int,
                    tile_px: int) -> List[Tuple[str, int]]:
    """``(label, nproc)`` at the set ranks that straddle a tile boundary:
    the in-set count before the tile's first pixel (the tile then holds no
    processed pixel) and one either side of it."""
    cum = torch.cumsum(pee_ops.parity_mask(h, w, parity).reshape(-1), 0)
    out = []
    for k in _tile_ends(h, w, tile_px):
        at = int(cum[k * tile_px - 1])
        out += [(f"set{k}{d:+d}", at + d) for d in (-1, 0, 1)]
    return out
