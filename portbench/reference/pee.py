"""Plain NumPy reference of strategy ``pee`` (prediction-error expansion)
for one image: threshold choice, both passes, the overflow map and the
container fields, written from the scheme's description:

* a pass takes the interior pixels of one checkerboard colour (``(y + x)
  & 1 == parity``, the one-pixel frame excluded) in raster order, predicts
  each from its four neighbours (floor of their mean, edges replicated)
  and expands errors ``-T <= e < T`` to ``2e + bit``, shifts larger ones
  by ``T`` away from 0, and leaves a pixel whose expanded (for either bit)
  or shifted value would leave ``[0, max_val]`` as it is, flagged in the
  overflow map;
* a pass stops after the pixel that takes its last bit (it processes
  every pixel of its colour when the payload outlasts it); pass 0 takes
  parity 0 and the payload's head, pass 1 parity 1 on pass 0's output and
  the rest;
* ``T`` starts at the least ``T >= pee_threshold`` at which pass 0's exact
  capacity plus pass 1's capacity measured on the unmarked image hold the
  payload (errors counted over ``[-128, 128)``, ``T <= 128``), and rises by
  one while the two passes fall short.

The passes are plain torch ops, on the CPU or the card. Nothing here
imports the program or JAX.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from . import raster, stgc

MAX_T = 128


def _predict(x: torch.Tensor) -> torch.Tensor:
    p = torch.cat([x[:1], x, x[-1:]], 0)
    p = torch.cat([p[:, :1], p, p[:, -1:]], 1)
    return (p[:-2, 1:-1] + p[2:, 1:-1] + p[1:-1, :-2] + p[1:-1, 2:]) >> 2


def _colour(h: int, w: int, parity: int, device) -> torch.Tensor:
    y = torch.arange(h, device=device)[:, None]
    x = torch.arange(w, device=device)[None, :]
    inner = (y > 0) & (y < h - 1) & (x > 0) & (x < w - 1)
    return (((y + x) & 1) == parity) & inner


def _expand_fits(pred, e, max_val):
    return ~((pred + 2 * e + 1 > max_val) | (pred + 2 * e < 0))


def capacities(x: torch.Tensor, parity: int, max_val: int) -> np.ndarray:
    """``caps[T - 1]``: pixels of the colour whose error lies in ``[-T, T)``
    and whose expansion fits, for ``T = 1 .. MAX_T``; ``x`` int32."""
    pred = _predict(x)
    e = x - pred
    ok = (_colour(*x.shape, parity, x.device) & _expand_fits(pred, e, max_val)
          & (e >= -MAX_T) & (e < MAX_T))
    hist = torch.bincount((e[ok] + MAX_T).ravel(), minlength=2 * MAX_T)
    c = np.concatenate([[0], np.cumsum(hist.cpu().numpy())])
    t = np.arange(1, MAX_T + 1)
    return c[MAX_T + t] - c[MAX_T - t]


def embed_pass(x: torch.Tensor, bits: torch.Tensor, base: int, want: int,
               parity: int, t: int, max_val: int):
    """``(out, overflow, used, nproc)`` of one pass over the int32 image
    ``x``: ``nproc`` is the rank in the colour's raster order of the last
    pixel processed, the image's pixel count when the payload outlasts the
    pass, 0 when nothing is."""
    h, w = x.shape
    pred = _predict(x)
    e = x - pred
    colour = _colour(h, w, parity, x.device)
    expandable = (e >= -t) & (e < t)
    shift_bad = torch.where(e >= t, x + t > max_val, x - t < 0)
    overflow = colour & torch.where(
        expandable, ~_expand_fits(pred, e, max_val), shift_bad)
    eligible = colour & expandable & ~overflow
    rank = torch.cumsum(eligible.ravel(), 0).reshape(h, w)
    cap = int(rank[-1, -1])
    used = min(want, cap)
    processed = colour & ((rank < want) | (eligible & (rank == want)))
    takes = eligible & (rank <= want)
    idx = (base + rank - 1).clamp(0, max(bits.numel() - 1, 0))
    bit = torch.where(takes, bits[idx].to(torch.int32), 0)
    e_new = torch.where(expandable, 2 * e + bit,
                        e + torch.where(e >= t, t, -t))
    change = processed & ~overflow & (takes | ~expandable)
    out = torch.where(change, pred + e_new, x)
    if want > cap:
        nproc = h * w
    elif used == 0:
        nproc = 0
    else:
        colour_rank = torch.cumsum(colour.ravel(), 0).reshape(h, w)
        nproc = int(colour_rank[processed].max())
    return out, overflow & processed, used, nproc


def encode_image(image: np.ndarray, bits: np.ndarray, cfg: dict,
                 device="cpu") -> dict:
    """What one image's PEE encode must give: ``header`` fields, ``stego``,
    the packed overflow ``maps`` and float64 ``metrics``. The passes run
    as plain torch ops on ``device``."""
    h, w = image.shape
    dtype_bits = image.dtype.itemsize * 8
    eff_bits = min(cfg["bits_stored"], dtype_bits)
    max_val = (1 << eff_bits) - 1
    if int(image.max()) > max_val:
        max_val = (1 << dtype_bits) - 1
    total = int(bits.size)
    x = torch.from_numpy(image.astype(np.int32)).to(device)
    msg = torch.from_numpy(np.asarray(bits, np.uint8)).to(device)
    comb = capacities(x, 0, max_val) + capacities(x, 1, max_val)
    t_min = max(1, int(cfg["pee_threshold"]))
    fits = np.nonzero(comb[t_min - 1:] >= total)[0]
    t = t_min + int(fits[0]) if fits.size else MAX_T
    while t <= MAX_T:
        s0, o0, used0, nproc0 = embed_pass(x, msg, 0, total, 0, t, max_val)
        s1, o1, used1, nproc1 = embed_pass(s0, msg, used0, total - used0, 1,
                                           t, max_val)
        if used0 + used1 >= total:
            break
        t += 1
    else:
        raise ValueError(f"{total} bits exceed the PEE capacity at T={MAX_T}")
    passes = 2 if used1 > 0 else 1
    ext = (t, passes, nproc0, nproc1, used0, used1)
    head = {
        "version": 2, "codec_id": stgc.CODEC_IDS[cfg["codec"]],
        "strategy_id": stgc.STRATEGY_IDS["pee"], "s": 0, "nbits": eff_bits,
        "bits_stored": eff_bits, "dtype_code": stgc.DTYPE_CODES[image.dtype.name],
        "flags": stgc.FLAG_HAS_BITMAPS, "width": w, "height": h,
        "start_offset": 0, "seed": cfg["seed"], "payload_bits": total,
        "sizes": (), "indices": (), "eff_lengths": (), "plane_starts": (),
        "ext": struct.pack(stgc.PEE_EXT, *ext),
    }
    stego = s1.cpu().numpy().astype(image.dtype)
    over = (o0 | o1).cpu().numpy().ravel().astype(np.uint8)
    return {"header": head, "stego": stego, "maps": np.packbits(over),
            "metrics": raster.quality(image, stego)}
