# Port of codec_tcc_tpu/ops/pee.py: the XLA formulas in torch (int32), over
# a batch dimension written out; the kernels that replace embed_pass and
# extract_pass on the GPU, and the two-pass chains embed_both_passes and
# extract_both_passes, live in ops/pee_kernels.py.
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
(:mod:`~codec_tcc_tpu_torch.ops.pee_kernels`): the wrappers run them for
CPU tensors and ``chip_smoke.py`` holds the CUDA kernels against them on
the card. Everything here is plain torch; nothing launches a kernel.

Images are ``(..., H, W)`` uint8/uint16 (the passes take ``(B, H, W)``),
widened to int32 for the arithmetic. The capacity histogram is a
``torch.bincount`` of the in-set, non-overflowing errors (the JAX package
sorts instead, a TPU workaround); its bins are the same.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = [
    "rhombus_predict",
    "capacity",
    "capacity_histogram",
    "capacities_by_threshold",
    "embed_pass",
    "extract_pass",
    "parity_mask",
]

_BIG = 2**31 - 1


def _set_rank(h: int, w: int, parity: int, device=None) -> torch.Tensor:
    """Closed-form inclusive rank among the interior checkerboard set in
    raster order, ``(H, W) int32`` (values are only meaningful on in-set
    pixels). The set is deterministic, so no data scan is needed."""
    y = torch.arange(h, dtype=torch.int32, device=device)[:, None]
    x = torch.arange(w, dtype=torch.int32, device=device)[None, :]
    # per-row in-set count for interior rows r in [1, h-2]:
    # x in [1, w-2] with (x & 1) == q, q = (parity + r) & 1
    q = (parity + y) & 1
    interior_row = (y >= 1) & (y <= h - 2)
    c = torch.where(q == 1, (w - 1) // 2, (w - 2) // 2).to(torch.int32)
    c = torch.where(interior_row, c, 0)[:, 0]
    row_excl = torch.cumsum(c, 0, dtype=torch.int32) - c   # rows before y
    in_row = torch.where(q == 1, (x + 1) // 2, x // 2)     # in-set x' <= x
    return (row_excl[:, None] + in_row).to(torch.int32)


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


def embed_pass(
    img: torch.Tensor,         # (B, H, W) uint8/uint16
    msg_bits: torch.Tensor,    # (B, L) uint8, zero-padded, L >= 1
    msg_base: torch.Tensor,    # (B,) int32: this pass's first message bit
    want_bits: torch.Tensor,   # (B,) int32: bits this pass should embed
    parity: int,
    t: int,
    max_val: int,
) -> Tuple[torch.Tensor, ...]:
    """One PEE pass per image, the plain version of K3. Returns ``(stego,
    overflow u8, used, n_proc, cap)``: the overflow map holds the processed
    overflow pixels; ``used = min(want, cap)``; ``n_proc`` is the set rank
    of the ``used``-th eligible pixel, or ``H*W`` when ``want > cap`` (a
    saturated pass processes the whole set)."""
    b, h, w = img.shape
    pred, e, in_set, expandable, overflow = _classify(img, parity, t, max_val)
    eligible = in_set & expandable & ~overflow

    set_rank = _set_rank(h, w, parity, img.device)
    elig_cum = _raster_cumsum(eligible)
    total_cap = elig_cum[:, -1, -1]
    want = want_bits.to(torch.int32)
    used = torch.minimum(want, total_cap)

    # smallest processed prefix (in set_rank counting) covering `used` bits
    hit = eligible & (elig_cum == used[:, None, None])
    first = torch.where(hit, set_rank, _BIG).amin(dim=(1, 2))
    n_proc = torch.where(
        want > total_cap,
        h * w,
        torch.where(used > 0, first, 0),
    ).to(torch.int32)
    processed = in_set & (set_rank <= n_proc[:, None, None])

    embeds = eligible & processed
    rank = elig_cum.to(torch.int64) - 1   # 0-based among eligible
    lpad = msg_bits.shape[1]
    midx = (msg_base.to(torch.int64)[:, None, None] + rank).clamp(0, lpad - 1)
    bits = torch.gather(
        msg_bits.to(torch.int32), 1, midx.reshape(b, h * w)
    ).reshape(b, h, w)

    e_new = torch.where(
        expandable,
        2 * e + torch.where(embeds, bits, 0),
        e + torch.where(e >= t, t, -t),
    )
    x_new = pred + e_new
    # only expand where a bit was embedded, otherwise only shift
    modify = processed & ~overflow & (embeds | ~expandable)
    out = torch.where(modify, x_new, img.to(torch.int32)).to(img.dtype)
    return out, (overflow & processed).to(torch.uint8), used, n_proc, total_cap


def extract_pass(
    stego: torch.Tensor,          # (B, H, W) uint8/uint16
    overflow_map: torch.Tensor,   # (B, H, W) bool/uint8
    n_proc: torch.Tensor,         # (B,) int32
    parity: int,
    t: int,
    out_len: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Invert one PEE pass per image, the plain version of K4. Returns
    ``(restored, bits (B, out_len) uint8, n_bits (B,) int32)``: bit ``r``
    of a row is the bit of the expanded pixel of raster rank ``r``, 0 past
    ``n_bits``; ranks at or past ``out_len`` are dropped."""
    b, h, w = stego.shape
    x2 = stego.to(torch.int32)
    pred = rhombus_predict(stego)
    e2 = x2 - pred
    in_set = parity_mask(h, w, parity, stego.device)
    set_rank = _set_rank(h, w, parity, stego.device)
    processed = (in_set & (set_rank <= n_proc.to(torch.int32)[:, None, None])
                 & (overflow_map == 0))

    expanded = processed & (e2 >= -2 * t) & (e2 < 2 * t)
    bit = e2 & 1   # floor-mod 2 for int32
    e = torch.where(
        expanded,
        (e2 - bit) >> 1,
        e2 + torch.where(e2 >= 2 * t, -t, t),
    )
    restored = torch.where(processed, pred + e, x2).to(stego.dtype)

    flat = expanded.reshape(b, h * w)
    rank = torch.cumsum(flat, 1, dtype=torch.int64) - 1
    n_bits = flat.sum(1, dtype=torch.int32)
    # expanded pixels land at their rank; everything else in a spare column
    idx = torch.where(flat & (rank < out_len), rank, out_len)
    bits = torch.zeros((b, out_len + 1), dtype=torch.uint8, device=stego.device)
    bits.scatter_(1, idx, bit.reshape(b, h * w).to(torch.uint8))
    return restored, bits[:, :out_len].contiguous(), n_bits

