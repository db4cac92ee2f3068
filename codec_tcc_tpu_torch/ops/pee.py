# Port of codec_tcc_tpu/ops/pee.py: the XLA formulas in torch (int32), over
# a batch dimension written out, and the per-shard formulas of
# codec_tcc_tpu/parallel/tile_pee.py (the band versions); the kernels that
# replace embed_pass and extract_pass on the GPU, and the two-pass chains
# embed_both_passes and extract_both_passes, live in ops/pee_kernels.py.
"""Prediction-error expansion (PEE) ops in plain torch.

The scheme (see :mod:`codec_tcc_tpu_torch.models.pee`): pixels split into a
checkerboard of two colours; a pass predicts each interior pixel of one
colour from its four neighbours of the other colour (rhombus predictor,
floor of the mean), expands errors ``-T <= e < T`` to ``2e + bit`` and
shifts larger ones by ``T``, leaves pixels whose result would leave
``[0, max_val]`` untouched and flags them in an overflow map, and stops
after the shortest raster prefix of the set that holds the pass's bits.

:func:`embed_pass` and :func:`extract_pass` are the plain versions of the
kernels K3 ``pee_embed`` and K4 ``pee_extract``
(:mod:`~codec_tcc_tpu_torch.ops.pee_kernels`), and
:func:`embed_pass_band` and :func:`extract_pass_band` the passes over a band
of rows of a larger image, with the rows around it, its global row offset
and the eligible count of the rows above it
(:mod:`~codec_tcc_tpu_torch.parallel.tile_pee`). A whole image is one
band, so the whole-image passes run through the band versions. The band
kernels' plain versions follow their two launches each:
:func:`band_tile_counts` and :func:`band_extract_tile_counts` (the count of
each :data:`TILE_PX`-pixel tile) and :func:`embed_pass_band_tiles` (the
apply from the tiles' offsets, equal to :func:`embed_pass_band`). The
wrappers run them for CPU tensors and ``chip_smoke.py`` holds the CUDA
kernels against them on the card. Everything here is plain torch;
nothing launches a kernel.

Images are ``(..., H, W)`` uint8/uint16 (the passes take ``(B, H, W)``),
widened to int32 for the arithmetic. The capacity histogram is a
``torch.bincount`` of the in-set, non-overflowing errors (the JAX package
sorts instead, a TPU workaround); its bins are the same.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = [
    "TILE_PX",
    "rhombus_predict",
    "capacity",
    "capacity_histogram",
    "capacities_by_threshold",
    "error_histogram",
    "band_capacity_histogram",
    "band_eligible_count",
    "band_set_count",
    "band_tile_counts",
    "band_extract_tile_counts",
    "embed_pass",
    "embed_pass_band",
    "embed_pass_band_tiles",
    "extract_pass",
    "extract_pass_band",
    "parity_mask",
]

# Pixels per tile of the kernels K3/K4 (csrc/pee_common.cuh PEE_TILE_PX):
# a band kernel's count launch counts each TILE_PX consecutive band pixels.
TILE_PX = 4096

def rhombus_predict(img: torch.Tensor) -> torch.Tensor:
    """Floor-average of the 4-neighbourhood with edge replication. int32."""
    x = img.to(torch.int32)
    h, w = x.shape[-2:]
    r = torch.arange(h, device=x.device)
    c = torch.arange(w, device=x.device)
    s = (x[..., (r - 1).clamp(min=0), :] + x[..., (r + 1).clamp(max=h - 1), :]
         + x[..., :, (c - 1).clamp(min=0)] + x[..., :, (c + 1).clamp(max=w - 1)])
    return s >> 2      # the sum is >= 0: the shift is the floor division


def parity_mask(h: int, w: int, parity: int, device=None) -> torch.Tensor:
    """Checkerboard set membership, **interior pixels only** ``(H, W)``.

    Border pixels are excluded from processing: with edge-replicated padding
    a border pixel is its own 4-neighbour, so its prediction would depend on
    its own (modified) value and decoding could not invert it. The 1-pixel
    frame always passes through unchanged."""
    y = torch.arange(h, device=device)[:, None]
    x = torch.arange(w, device=device)[None, :]
    interior = (y > 0) & (y < h - 1) & (x > 0) & (x < w - 1)
    return (((y + x) & 1) == parity) & interior


def _classify(img: torch.Tensor, parity: int, t: int, max_val: int):
    """Shared encode-side classification for one pass. Returns
    ``(pred, e, in_set, expandable, overflow)``, all over the full image."""
    h, w = img.shape[-2:]
    x = img.to(torch.int32)
    pred = rhombus_predict(img)
    e = x - pred
    in_set = parity_mask(h, w, parity, img.device)
    expandable = (e >= -t) & (e < t)
    # worst-case expansion target must stay in range for either bit value
    exp_over = (pred + 2 * e + 1 > max_val) | (pred + 2 * e < 0)
    shift_over = torch.where(e >= t, x + t > max_val, x - t < 0)
    overflow = in_set & torch.where(expandable, exp_over, shift_over)
    return pred, e, in_set, expandable, overflow


def capacity(img: torch.Tensor, parity: int, t: int, max_val: int) -> torch.Tensor:
    """Number of embeddable bits a pass offers (eligible pixels), per image."""
    _, _, in_set, expandable, overflow = _classify(img, parity, t, max_val)
    return (in_set & expandable & ~overflow).sum(dim=(-2, -1), dtype=torch.int32)


def capacity_histogram(
    img: torch.Tensor, parity: int, t_max: int, max_val: int
) -> torch.Tensor:
    """Capacity-exact prediction-error histogram for one pass, ``(...,
    2*t_max) int32``: counts of ``e = x - pred`` over in-set pixels whose
    EXPANSION stays in range, bin ``k`` holding ``e = k - t_max``. The
    central sums give the exact eligible capacity at every threshold::

        cap(T) = hist[..., t_max-T : t_max+T].sum(-1)
               == capacity(img, parity, T, max_val)   for all T <= t_max
    """
    lead = img.shape[:-2]
    h, w = img.shape[-2:]
    x = img.to(torch.int32)
    pred = rhombus_predict(img)
    e = x - pred
    in_set = parity_mask(h, w, parity, img.device)
    exp_over = (pred + 2 * e + 1 > max_val) | (pred + 2 * e < 0)
    ok = in_set & ~exp_over & (e >= -t_max) & (e < t_max)
    nbins = 2 * t_max
    nimg = 1
    for d in lead:
        nimg *= d
    ok = ok.reshape(nimg, h * w)
    idx = (e.reshape(nimg, h * w).to(torch.int64) + t_max
           + nbins * torch.arange(nimg, device=img.device)[:, None])
    hist = torch.bincount(idx[ok], minlength=nimg * nbins)
    return hist.to(torch.int32).reshape(*lead, nbins)


def error_histogram(img: torch.Tensor, parity: int,
                    t_max: int = 64) -> torch.Tensor:
    """Prediction-error histogram for one pass, ``(..., 2*t_max + 1)``
    int32: counts of ``e = x - pred`` over the in-set pixels, clamped to
    ``[-t_max, t_max]`` (bin 0 <=> ``e = -t_max``). The central ``2T``
    bins sum to the expandable pixels at threshold ``T``. The JAX package
    sorts instead of a ``bincount`` (a TPU workaround); the bins are the
    same."""
    lead = img.shape[:-2]
    h, w = img.shape[-2:]
    e = img.to(torch.int32) - rhombus_predict(img)
    in_set = parity_mask(h, w, parity, img.device).reshape(-1)
    nbins = 2 * t_max + 1
    nimg = 1
    for d in lead:
        nimg *= d
    idx = (e.reshape(nimg, h * w).clamp(-t_max, t_max).to(torch.int64)
           + t_max + nbins * torch.arange(nimg, device=img.device)[:, None])
    hist = torch.bincount(idx[:, in_set].reshape(-1),
                          minlength=nimg * nbins)
    return hist.to(torch.int32).reshape(*lead, nbins)


# Copy of codec_tcc_tpu/ops/pee.py::capacities_by_threshold (numpy only).
def capacities_by_threshold(hist) -> "np.ndarray":
    """Host helper: ``(..., 2*t_max)`` capacity histogram(s) ->
    ``(..., t_max)`` exact capacities, ``caps[..., T-1] = cap(T)``."""
    import numpy as np

    hist = np.asarray(hist)
    t_max = hist.shape[-1] // 2
    c = np.cumsum(hist, axis=-1)
    ts = np.arange(1, t_max + 1)
    hi = c[..., t_max + ts - 1]
    lo_idx = t_max - ts - 1
    lo = np.where(lo_idx >= 0, c[..., np.maximum(lo_idx, 0)], 0)
    return hi - lo


def _raster_cumsum(mask: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix count of a boolean ``(B, H, W)`` mask in raster
    order, int32."""
    b, h, w = mask.shape
    return torch.cumsum(mask.reshape(b, h * w), 1, dtype=torch.int32).reshape(
        b, h, w)


def _predict_band(band: torch.Tensor, top: torch.Tensor,
                  bottom: torch.Tensor) -> torch.Tensor:
    """Rhombus prediction of a ``(B, lh, W)`` band of rows of a larger
    image, its first and last rows predicted from the neighbour rows
    ``top``/``bottom`` ``(B, W)`` (a band at the image's border passes its
    own edge row: :func:`rhombus_predict`'s edge replication). int32."""
    x = torch.cat([top.to(torch.int32)[:, None], band.to(torch.int32),
                   bottom.to(torch.int32)[:, None]], 1)
    w = x.shape[-1]
    c = torch.arange(w, device=x.device)
    mid = x[:, 1:-1]
    s = (x[:, :-2] + x[:, 2:] + mid[..., (c - 1).clamp(min=0)]
         + mid[..., (c + 1).clamp(max=w - 1)])
    return s >> 2      # the sum is >= 0: the shift is the floor division


# The closed form of codec_tcc_tpu/parallel/tile_pee.py::_global_geometry.
def _band_geometry(lh: int, w: int, row0: torch.Tensor, height: int,
                   parity: int):
    """``(in_set, set_rank)`` ``(B, lh, W)`` of a band whose first row is
    global row ``row0`` ``(B,)`` of an image ``height`` rows tall: the
    interior checkerboard set and the inclusive raster rank in it, from
    the global row (``set_rank`` only means something on in-set pixels)."""
    dev = row0.device
    y = (row0.to(torch.int32)[:, None, None]
         + torch.arange(lh, dtype=torch.int32, device=dev)[None, :, None])
    x = torch.arange(w, dtype=torch.int32, device=dev)[None, None, :]
    interior = (y >= 1) & (y <= height - 2) & (x >= 1) & (x <= w - 2)
    in_set = (((y + x) & 1) == parity) & interior
    m = torch.clamp(y - 1, min=0).clamp(max=max(height - 2, 0))
    n_q1 = (m + 1) // 2 if parity % 2 == 0 else m // 2
    row_excl = n_q1 * ((w - 1) // 2) + (m - n_q1) * ((w - 2) // 2)
    in_row = torch.where(((parity + y) & 1) == 1, (x + 1) // 2, x // 2)
    return in_set, row_excl + in_row


# The classification of codec_tcc_tpu/parallel/tile_pee.py::_shard_classify
# (which pallas_pee._classify equals), over a band.
def _band_classify(band, top, bottom, row0, height: int, parity: int, t: int,
                   max_val: int):
    """``(x, pred, e, in_set, set_rank, expandable, overflow, eligible)``
    of one pass over a band (see :func:`embed_pass_band`)."""
    x = band.to(torch.int32)
    pred = _predict_band(band, top, bottom)
    e = x - pred
    in_set, set_rank = _band_geometry(band.shape[1], band.shape[2], row0,
                                      height, parity)
    expandable = (e >= -t) & (e < t)
    # worst-case expansion target must stay in range for either bit value
    exp_over = (pred + 2 * e + 1 > max_val) | (pred + 2 * e < 0)
    shift_over = torch.where(e >= t, x + t > max_val, x - t < 0)
    overflow = in_set & torch.where(expandable, exp_over, shift_over)
    eligible = in_set & expandable & ~overflow
    return x, pred, e, in_set, set_rank, expandable, overflow, eligible


def band_eligible_count(band, top, bottom, row0, parity: int, t: int,
                        max_val: int, height: int) -> torch.Tensor:
    """The band's eligible pixels (embeddable bits) per image, ``(B,)``
    int32: the count the bands below it take as their ``rank_base``."""
    eligible = _band_classify(band, top, bottom, row0, height, parity, t,
                              max_val)[-1]
    return eligible.sum(dim=(1, 2), dtype=torch.int32)


def _rows_before_set_count(y: int, height: int, w: int, parity: int) -> int:
    """In-set pixels in the rows above global row ``y`` (the closed form of
    :func:`_band_geometry` at column 0, in host ints)."""
    m = min(max(y - 1, 0), max(height - 2, 0))   # interior rows before y
    n_q1 = (m + 1) // 2 if parity % 2 == 0 else m // 2
    return n_q1 * ((w - 1) // 2) + (m - n_q1) * (max(w - 2, 0) // 2)


def band_set_count(row0: int, lh: int, height: int, w: int,
                   parity: int) -> int:
    """In-set pixels of the band of rows ``[row0, row0 + lh)``: the most
    bits one pass can carry there (K4's band bit row holds as many)."""
    return (_rows_before_set_count(row0 + lh, height, w, parity)
            - _rows_before_set_count(row0, height, w, parity))


def _row0s(row0: int, band: torch.Tensor) -> torch.Tensor:
    """The band kernels' by-value first row as the ``(B,)`` int32 tensor
    the band formulas take."""
    return torch.full((band.shape[0],), row0, dtype=torch.int32,
                      device=band.device)


def _tiles(mask: torch.Tensor) -> torch.Tensor:
    """A ``(B, lh, W)`` mask as ``(B, tiles, TILE_PX)`` int32, zero-padded
    past the band's last pixel: the kernels' tiles of consecutive band
    pixels."""
    b = mask.shape[0]
    flat = mask.reshape(b, -1).to(torch.int32)
    n = flat.shape[1]
    tiles = -(-n // TILE_PX)
    flat = torch.nn.functional.pad(flat, (0, tiles * TILE_PX - n))
    return flat.reshape(b, tiles, TILE_PX)


def band_tile_counts(band, top, bottom, row0: int, height: int, parity: int,
                     t: int, max_val: int) -> torch.Tensor:
    """Each :data:`TILE_PX`-pixel tile's eligible pixels, ``(B, tiles)``
    int32, the plain version of K3's band count launch: a tile covers band
    pixels ``[j * TILE_PX, (j + 1) * TILE_PX)`` in raster order, and a
    row sums to :func:`band_eligible_count`."""
    eligible = _band_classify(band, top, bottom, _row0s(row0, band), height,
                              parity, t, max_val)[-1]
    return _tiles(eligible).sum(2, dtype=torch.int32)


def band_capacity_histogram(band, top, bottom, row0, parity: int,
                            t_max: int, max_val: int,
                            height: int) -> torch.Tensor:
    """:func:`capacity_histogram` of the band's pixels, ``(B, 2*t_max)``
    int32: the histograms of an image's bands sum to the image's."""
    b = band.shape[0]
    x, pred, e, in_set = _band_classify(band, top, bottom, row0, height,
                                        parity, t_max, max_val)[:4]
    exp_over = (pred + 2 * e + 1 > max_val) | (pred + 2 * e < 0)
    ok = (in_set & ~exp_over & (e >= -t_max) & (e < t_max)).reshape(b, -1)
    nbins = 2 * t_max
    idx = (e.reshape(b, -1).to(torch.int64) + t_max
           + nbins * torch.arange(b, device=band.device)[:, None])
    hist = torch.bincount(idx[ok], minlength=b * nbins)
    return hist.to(torch.int32).reshape(b, nbins)


def _embed_band_apply(band, cls, grank, msg_bits, msg_base, want_bits,
                      t: int):
    """The pass over a band from its classification ``cls``
    (:func:`_band_classify`) and each pixel's global eligible rank
    ``grank``: ``(stego, overflow u8, nproc)`` of :func:`embed_pass_band`."""
    b, lh, w = band.shape
    x, pred, e, in_set, set_rank, expandable, overflow, eligible = cls
    want = want_bits.to(torch.int32)[:, None, None]
    embeds = eligible & (grank <= want)
    processed = in_set & ((grank < want) | (eligible & (grank == want)))

    lpad = msg_bits.shape[1]
    midx = (msg_base.to(torch.int64)[:, None, None] + grank.to(torch.int64)
            - 1).clamp(0, lpad - 1)
    bits = torch.gather(
        msg_bits.to(torch.int32), 1, midx.reshape(b, lh * w)
    ).reshape(b, lh, w)

    e_new = torch.where(
        expandable,
        2 * e + torch.where(embeds, bits, 0),
        e + torch.where(e >= t, t, -t),
    )
    # only expand where a bit was embedded, otherwise only shift
    modify = processed & ~overflow & (embeds | ~expandable)
    out = torch.where(modify, pred + e_new, x).to(band.dtype)
    nproc = torch.where(processed, set_rank, 0).amax(dim=(1, 2))
    return out, (overflow & processed).to(torch.uint8), nproc


def embed_pass_band(
    band: torch.Tensor,        # (B, lh, W) uint8/uint16: rows of an image
    top: torch.Tensor,         # (B, W): the row above the band, or its first
    bottom: torch.Tensor,      # (B, W): the row below it, or its last
    row0: torch.Tensor,        # (B,) int32: the band's first global row
    rank_base: torch.Tensor,   # (B,) int32: eligible pixels of the rows above
    msg_bits: torch.Tensor,    # (B, L) uint8, the whole message, L >= 1
    msg_base: torch.Tensor,    # (B,) int32: this pass's first message bit
    want_bits: torch.Tensor,   # (B,) int32: bits the whole pass should embed
    parity: int,
    t: int,
    max_val: int,
    height: int,               # the image's rows
) -> Tuple[torch.Tensor, ...]:
    """One PEE pass over a band of rows of an image ``height`` rows tall.
    Returns ``(stego, overflow u8, count, nproc)``: ``count`` is the band's
    eligible pixels and ``nproc`` the largest set rank the band processes
    (0 if none).

    A pixel's global eligible rank is ``rank_base`` plus its inclusive rank
    in the band. The pass processes the in-set pixels up to the
    ``want``-th eligible pixel of the image (all of them past ``cap``), so
    a band needs no global boundary; the caller combines the bands:
    ``used = min(want, cap)`` and ``nproc = H*W`` when ``want > cap``, else
    the largest band ``nproc``."""
    cls = _band_classify(band, top, bottom, row0, height, parity, t, max_val)
    eligible = cls[-1]
    grank = (rank_base.to(torch.int32)[:, None, None]
             + _raster_cumsum(eligible))
    out, over, nproc = _embed_band_apply(band, cls, grank, msg_bits,
                                         msg_base, want_bits, t)
    return out, over, eligible.sum(dim=(1, 2), dtype=torch.int32), nproc


def embed_pass_band_tiles(band, top, bottom, row0: int, height: int, counts,
                          rank_base, msg_bits, msg_base: int, want: int,
                          parity: int, t: int, max_val: int):
    """The plain version of K3's band apply launch: :func:`embed_pass_band`
    with each pixel ranked from the tiles' counts (``counts`` ``(B,
    tiles)``, :func:`band_tile_counts`), as the kernel's blocks rank theirs:
    ``rank_base`` (``(B,)`` int32, or None for 0), plus the counts of the
    tiles before the pixel's tile, plus its inclusive rank in its tile.
    ``row0``, ``msg_base`` and ``want`` are the launch's by-value ints.
    Returns ``(stego, overflow u8, nproc)``, equal to
    :func:`embed_pass_band`'s."""
    b, lh, w = band.shape
    rows = _row0s(row0, band)
    cls = _band_classify(band, top, bottom, rows, height, parity, t, max_val)
    counts = counts.to(torch.int32)
    before = torch.cumsum(counts, 1, dtype=torch.int32) - counts
    if rank_base is not None:
        before = before + rank_base.to(torch.int32)[:, None]
    grank = before[:, :, None] + torch.cumsum(_tiles(cls[-1]), 2,
                                              dtype=torch.int32)
    grank = grank.reshape(b, -1)[:, :lh * w].reshape(b, lh, w)
    return _embed_band_apply(band, cls, grank, msg_bits,
                             torch.full_like(rows, msg_base),
                             torch.full_like(rows, want), t)


def _extract_band_classify(band, top, bottom, row0, overflow_map, n_proc,
                           parity: int, t: int, height: int):
    """``(x2, pred, e2, processed, expanded, bit)`` of the inverse of one
    pass over a band (see :func:`extract_pass_band`)."""
    x2 = band.to(torch.int32)
    pred = _predict_band(band, top, bottom)
    e2 = x2 - pred
    in_set, set_rank = _band_geometry(band.shape[1], band.shape[2], row0,
                                      height, parity)
    processed = (in_set & (set_rank <= n_proc.to(torch.int32)[:, None, None])
                 & (overflow_map == 0))
    expanded = processed & (e2 >= -2 * t) & (e2 < 2 * t)
    bit = e2 & 1   # floor-mod 2 for int32
    return x2, pred, e2, processed, expanded, bit


def band_extract_tile_counts(band, top, bottom, row0: int, height: int,
                             overflow_map, n_proc: int, parity: int,
                             t: int) -> torch.Tensor:
    """Each :data:`TILE_PX`-pixel tile's expanded processed pixels (the bits
    it carries), ``(B, tiles)`` int32: the plain version of K4's band count
    launch. ``row0`` and ``n_proc`` are the launch's by-value ints."""
    rows = _row0s(row0, band)
    expanded = _extract_band_classify(
        band, top, bottom, rows, overflow_map, torch.full_like(rows, n_proc),
        parity, t, height)[4]
    return _tiles(expanded).sum(2, dtype=torch.int32)


def extract_pass_band(
    band: torch.Tensor,           # (B, lh, W) uint8/uint16 stego rows
    top: torch.Tensor,            # (B, W) neighbour rows, as in the embed
    bottom: torch.Tensor,
    row0: torch.Tensor,           # (B,) int32: the band's first global row
    overflow_map: torch.Tensor,   # (B, lh, W) bool/uint8
    n_proc: torch.Tensor,         # (B,) int32: the pass's global boundary
    parity: int,
    t: int,
    out_len: int,
    height: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Invert one PEE pass over a band. Returns ``(restored, bits (B,
    out_len) uint8, n_bits (B,) int32)``: bit ``r`` of a row is the bit of
    the band's expanded pixel of band rank ``r`` (the caller places a
    band's bits after those of the bands above it), 0 past ``n_bits``;
    ranks at or past ``out_len`` are dropped."""
    b, lh, w = band.shape
    x2, pred, e2, processed, expanded, bit = _extract_band_classify(
        band, top, bottom, row0, overflow_map, n_proc, parity, t, height)
    e = torch.where(
        expanded,
        (e2 - bit) >> 1,
        e2 + torch.where(e2 >= 2 * t, -t, t),
    )
    restored = torch.where(processed, pred + e, x2).to(band.dtype)

    flat = expanded.reshape(b, lh * w)
    rank = torch.cumsum(flat, 1, dtype=torch.int64) - 1
    n_bits = flat.sum(1, dtype=torch.int32)
    # expanded pixels land at their rank; everything else in a spare column
    idx = torch.where(flat & (rank < out_len), rank, out_len)
    bits = torch.zeros((b, out_len + 1), dtype=torch.uint8, device=band.device)
    bits.scatter_(1, idx, bit.reshape(b, lh * w).to(torch.uint8))
    return restored, bits[:, :out_len].contiguous(), n_bits


def _whole_image(img: torch.Tensor):
    """An image as its own one band: its edge rows as the neighbours, row 0
    first, nothing above it."""
    zeros = torch.zeros(img.shape[0], dtype=torch.int32, device=img.device)
    return img[:, 0], img[:, -1], zeros


def embed_pass(
    img: torch.Tensor,         # (B, H, W) uint8/uint16
    msg_bits: torch.Tensor,    # (B, L) uint8, zero-padded, L >= 1
    msg_base: torch.Tensor,    # (B,) int32: this pass's first message bit
    want_bits: torch.Tensor,   # (B,) int32: bits this pass should embed
    parity: int,
    t: int,
    max_val: int,
) -> Tuple[torch.Tensor, ...]:
    """One PEE pass per image, the plain version of K3: the image as one
    band (:func:`embed_pass_band`). Returns ``(stego, overflow u8, used,
    n_proc, cap)``: the overflow map holds the processed overflow pixels;
    ``used = min(want, cap)``; ``n_proc`` is the set rank of the
    ``used``-th eligible pixel, or ``H*W`` when ``want > cap`` (a saturated
    pass processes the whole set)."""
    b, h, w = img.shape
    top, bottom, zeros = _whole_image(img)
    out, over, cap, last = embed_pass_band(
        img, top, bottom, zeros, zeros, msg_bits, msg_base, want_bits,
        parity, t, max_val, h)
    want = want_bits.to(torch.int32)
    used = torch.minimum(want, cap)
    # unsaturated, the largest processed set rank is the used-th eligible
    # pixel's
    n_proc = torch.where(want > cap, h * w,
                         torch.where(used > 0, last, 0)).to(torch.int32)
    return out, over, used, n_proc, cap


def extract_pass(
    stego: torch.Tensor,          # (B, H, W) uint8/uint16
    overflow_map: torch.Tensor,   # (B, H, W) bool/uint8
    n_proc: torch.Tensor,         # (B,) int32
    parity: int,
    t: int,
    out_len: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Invert one PEE pass per image, the plain version of K4: the image as
    one band (:func:`extract_pass_band`). Returns ``(restored, bits (B,
    out_len) uint8, n_bits (B,) int32)``: bit ``r`` of a row is the bit of
    the expanded pixel of raster rank ``r``, 0 past ``n_bits``; ranks at or
    past ``out_len`` are dropped."""
    top, bottom, zeros = _whole_image(stego)
    return extract_pass_band(stego, top, bottom, zeros, overflow_map,
                             n_proc, parity, t, out_len, stego.shape[1])
