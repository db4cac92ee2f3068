"""One PEE pass band by band through K3/K4's shard mode, shared by
``chip_smoke.py`` (its tiled phase) and ``tests/test_torch_cuda.py``.

An image ``(1, H, W)`` splits into K bands of ``ceil(H/K)`` rows (the last
shorter), each with its neighbours' edge rows as halo (its own at the
image's border) and its first global row; the rank prefix of a band is the
plain eligible count of the bands above it, as in
``codec_tcc_tpu_torch/parallel/tile_pee.py``. ``embed`` and ``extract``
take the wrapper to run (``pee_embed`` / ``pee_extract`` for the kernel,
``pee_embed_plain`` / ``pee_extract_plain`` for the plain band version,
on any device) and return every band's outputs and their combination,
which must equal the whole-image pass."""

from __future__ import annotations

from typing import List, Tuple

import torch

from codec_tcc_tpu_torch.ops import pee as pee_ops


def bands(h: int, k: int) -> List[Tuple[int, int]]:
    """(first row, end row) of the non-empty bands of K."""
    lh = -(-h // k)
    return [(a, min(a + lh, h)) for a in range(0, h, lh)]


def halo(img: torch.Tensor, a: int, b: int):
    """(top, bottom) ``(1, W)`` rows of band [a, b) of a ``(1, H, W)``
    image: the neighbours' edge rows, its own at the border."""
    h = img.shape[1]
    top = img[:, a - 1] if a > 0 else img[:, a]
    bot = img[:, b] if b < h else img[:, b - 1]
    return top.contiguous(), bot.contiguous()


def _cat_rows(parts) -> torch.Tensor:
    """``torch.cat`` along the rows; uint16 through the int16 view (the
    same bits), which CUDA concatenates."""
    if parts[0].dtype == torch.uint16:
        return torch.cat([p.view(torch.int16) for p in parts], 1).view(
            torch.uint16)
    return torch.cat(parts, 1)


def _i32(v: int, dev) -> torch.Tensor:
    return torch.tensor([int(v)], dtype=torch.int32, device=dev)


def embed(fn, img, msg, base: int, want: int, parity: int, t: int,
          max_val: int, k: int):
    """K3 over K bands of ``img`` ``(1, H, W)``. Returns ``(per_band,
    (stego, overflow, used, nproc))``: per band ``(stego, overflow, count,
    nproc)`` as the wrapper gave them; the combination on the host."""
    h, w = img.shape[1:]
    dev = img.device
    rank_base, per_band = 0, []
    for a, b in bands(h, k):
        top, bot = halo(img, a, b)
        band = img[:, a:b].contiguous()
        out = fn(band, msg, _i32(base, dev), _i32(want, dev), parity, t,
                 max_val, shard=(top, bot, _i32(a, dev), _i32(rank_base, dev),
                                 h))
        per_band.append(out)
        rank_base += int(pee_ops.band_eligible_count(
            band, top, bot, _i32(a, dev), parity, t, max_val, h)[0])
    stego = _cat_rows([o[0] for o in per_band])
    over = _cat_rows([o[1] for o in per_band])
    used = min(want, rank_base)
    nproc = h * w if want > rank_base else (
        max(int(o[3][0]) for o in per_band) if used > 0 else 0)
    return per_band, (stego, over, used, nproc)


def extract(fn, stego, over, nproc: int, parity: int, t: int, out_len: int,
            k: int):
    """K4 over K bands. Returns ``(per_band, (restored, bits (out_len,),
    n_bits))``: per band ``(restored, bits, nbits)``; each band's bits
    placed after the counts of the bands above it."""
    h = stego.shape[1]
    dev = stego.device
    per_band, runs = [], []
    for a, b in bands(h, k):
        top, bot = halo(stego, a, b)
        out = fn(stego[:, a:b].contiguous(), over[:, a:b].contiguous(),
                 _i32(nproc, dev), parity, t, out_len,
                 shard=(top, bot, _i32(a, dev), h))
        per_band.append(out)
    bits = torch.zeros(out_len, dtype=torch.uint8)
    off = 0
    for _, bits_k, n_k in per_band:
        c = int(n_k[0])
        take = min(c, out_len - off)
        if take > 0:
            bits[off:off + take] = bits_k[0, :take].cpu()
        off += c
    restored = _cat_rows([o[0] for o in per_band])
    return per_band, (restored, bits, off)
