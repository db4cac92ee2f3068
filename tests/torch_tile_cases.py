"""One PEE pass band by band through K3/K4's band mode, shared by
``chip_smoke.py`` (its tiled phase) and the port's tests.

An image ``(1, H, W)`` splits into K bands of ``ceil(H/K)`` rows (the last
shorter), each with its neighbours' edge rows as halo (its own at the
image's border) and its first global row; the rank base of a band is the
sum of the tile counts of the bands above it, as in
``codec_tcc_tpu_torch/parallel/tile_pee.py``. ``embed`` and ``extract``
run the band wrappers (``pee_count_band`` + ``pee_embed_band``,
``pee_extract_count_band`` + ``pee_extract_band``: the kernels on a CUDA
tensor) or, with ``plain=True``, their plain versions on any device, and
return every band's outputs and their combination, which must equal the
whole-image pass."""

from __future__ import annotations

from typing import List, Tuple

import torch

from codec_tcc_tpu_torch.ops import pee_kernels as pk


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


def embed(img, msg, base: int, want: int, parity: int, t: int,
          max_val: int, k: int, plain: bool = False):
    """K3 over K bands of ``img`` ``(1, H, W)``. Returns ``(per_band,
    (stego, overflow, used, nproc))``: per band ``(counts, stego,
    overflow, nproc)`` as the count and apply wrappers gave them; the
    combination on the host."""
    count_fn = pk.pee_count_band_plain if plain else pk.pee_count_band
    apply_fn = pk.pee_embed_band_plain if plain else pk.pee_embed_band
    h, w = img.shape[1:]
    dev = img.device
    rank_base, per_band = 0, []
    for a, b in bands(h, k):
        top, bot = halo(img, a, b)
        band = img[:, a:b].contiguous()
        counts = count_fn(band, top, bot, a, h, parity, t, max_val)
        out = apply_fn(band, top, bot, a, h, counts,
                       _i32(rank_base, dev) if a else None, msg, base, want,
                       parity, t, max_val)
        per_band.append((counts, *out))
        rank_base += int(counts.sum())
    stego = _cat_rows([o[1] for o in per_band])
    over = _cat_rows([o[2] for o in per_band])
    used = min(want, rank_base)
    nproc = h * w if want > rank_base else (
        max(int(o[3][0]) for o in per_band) if used > 0 else 0)
    return per_band, (stego, over, used, nproc)


def extract(stego, over, nproc: int, parity: int, t: int, out_len: int,
            k: int, plain: bool = False):
    """K4 over K bands. Returns ``(per_band, (restored, bits (out_len,),
    n_bits))``: per band ``(counts, restored, bits, nbits)``, the count
    launch's tile counts and the bits cut to their valid part (the
    kernel's row is not zeroed past it); each band's bits placed after the
    counts of the bands above it."""
    count_fn = (pk.pee_extract_count_band_plain if plain
                else pk.pee_extract_count_band)
    apply_fn = pk.pee_extract_band_plain if plain else pk.pee_extract_band
    h = stego.shape[1]
    per_band = []
    for a, b in bands(h, k):
        top, bot = halo(stego, a, b)
        args = (stego[:, a:b].contiguous(), top, bot, a, h,
                over[:, a:b].contiguous(), nproc, parity, t)
        restored, bits_k, n_k = apply_fn(*args, out_len)
        valid = min(int(n_k[0]), bits_k.shape[1])
        per_band.append((count_fn(*args), restored, bits_k[:, :valid], n_k))
    bits = torch.zeros(out_len, dtype=torch.uint8)
    off = 0
    for *_, bits_k, n_k in per_band:
        c = int(n_k[0])
        take = min(c, out_len - off)
        if take > 0:
            bits[off:off + take] = bits_k[0, :take].cpu()
        off += c
    restored = _cat_rows([o[1] for o in per_band])
    return per_band, (restored, bits, off)
