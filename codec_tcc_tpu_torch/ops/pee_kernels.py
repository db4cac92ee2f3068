"""Hand-written CUDA kernels of the PEE path, their wrappers and counts.

* **K3** :func:`pee_embed` (``csrc/pee_embed.cu``) — one prediction-error
  expansion pass over a batch of images. Replaces the Pallas
  ``_embed_call``/``_embed_kernel`` of ``codec_tcc_tpu/ops/pallas_pee.py``.
* **K4** :func:`pee_extract` (``csrc/pee_extract.cu``) — its inverse, with
  the bits in message order. Replaces ``_extract_call``/``_extract_kernel``
  and the host join of their per-tile segments (``collect_bits``).

:func:`embed_both_passes` and :func:`extract_both_passes` chain two calls of
a wrapper, pass 1's base and budget taken from pass 0's device results.

Their band mode (``csrc/pee_embed.cu``, ``csrc/pee_extract.cu``) runs one
pass on a band of rows of a larger image per batch entry, the counterpart
of the Pallas kernels' ``pos_base``/``rank_base`` (reached there through
``embed_pass_batch(shard=...)``/``extract_pass_batch(shard=...)``), in
two launches each: :func:`pee_count_band` writes each tile's eligible
count, and :func:`pee_embed_band` ranks its tiles from those counts and a
rank base on the device; :func:`pee_extract_band` runs
:func:`pee_extract_count_band` and its own apply launch into a bit row of
the band's size. The band's first row, the pass's message base, budget
and boundary are by-value ints, so no launch copies a scalar to the card.
Their plain versions are :func:`.pee.band_tile_counts`,
:func:`.pee.embed_pass_band_tiles`, :func:`.pee.band_extract_tile_counts`
and :func:`pee_extract_band_plain`; :mod:`..parallel.tile_pee` is their
caller.

Both kernels take a batch: images ``(B, H, W)`` of any geometry with
per-image ``(B,)`` int32 tensors on the same device, so a pass's base and
budget can be the previous pass's device results. A wrapper given CUDA tensors
launches its kernel on the current stream or raises; given CPU tensors it
runs the plain torch version from :mod:`.pee`. Nothing falls back from the
kernel to the plain version. The kernels are built with the raster kernels
into one library (:mod:`.kernel_library`).

:data:`KERNELS` names the kernels; a wrapper call that launched one adds
one to the counter ``launch.<kernel>`` of :mod:`..profiling`; plain-version
calls do not count. A call of :func:`pee_embed` or
:func:`pee_extract` is one memset and ONE kernel launch: the tiles' global
ranks come from a decoupled look-back (``csrc/pee_common.cuh``). K3's
memset zeroes its scratch, K4's its scratch and the bit rows, which share
one allocation. The band launches take no ticket, no look-back and no
memset.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from .. import profiling
from . import pee as pee_ops
from .kernel_library import check, library, stream_ptr

__all__ = [
    "KERNELS",
    "embed_both_passes",
    "extract_both_passes",
    "pee_count_band",
    "pee_count_band_plain",
    "pee_embed",
    "pee_embed_band",
    "pee_embed_band_plain",
    "pee_embed_plain",
    "pee_extract",
    "pee_extract_band",
    "pee_extract_band_plain",
    "pee_extract_count_band",
    "pee_extract_count_band_plain",
    "pee_extract_plain",
]

KERNELS = ("pee_embed", "pee_extract", "pee_count_band", "pee_embed_band",
           "pee_extract_count_band", "pee_extract_band")


def _check_images(imgs: torch.Tensor, what: str) -> None:
    if imgs.dtype not in (torch.uint8, torch.uint16):
        raise ValueError(f"{what} must be uint8/uint16, got {imgs.dtype}")
    if imgs.dim() != 3 or min(imgs.shape) < 1:
        raise ValueError(f"{what} must be a non-empty (B, H, W) tensor, got "
                         f"shape {tuple(imgs.shape)}")
    if imgs.shape[1] * imgs.shape[2] >= 1 << 31 or imgs.shape[0] > 65535:
        raise ValueError(f"{what} of shape {tuple(imgs.shape)} exceeds the "
                         f"int32 pixel index or 65535 images")


def _check_scalars(b: int, device: torch.device, **named) -> None:
    for name, v in named.items():
        if v.dtype != torch.int32 or v.shape != (b,) or v.device != device:
            raise ValueError(
                f"{name} must be a (B,) = ({b},) int32 tensor on {device}, "
                f"got {v.dtype} {tuple(v.shape)} on {v.device}"
            )


def _check_pass(parity: int, t: int) -> None:
    if parity not in (0, 1):
        raise ValueError(f"parity must be 0 or 1, got {parity}")
    if t < 1:
        raise ValueError(f"threshold t must be >= 1, got {t}")


def _check_band(band: torch.Tensor, top, bottom, row0: int,
                height: int) -> None:
    """A band: ``(B, lh, W)`` uint8/uint16 rows ``[row0, row0 + lh)`` of an
    image ``height`` rows tall, ``top``/``bottom`` ``(B, W)`` rows of its
    dtype on its device."""
    _check_images(band, "band")
    b, lh, w = band.shape
    for name, row in (("top", top), ("bottom", bottom)):
        if row.dtype != band.dtype or row.shape != (b, w) \
                or row.device != band.device:
            raise ValueError(
                f"{name} must be a (B, W) = ({b}, {w}) {band.dtype} tensor "
                f"on {band.device}, got {row.dtype} {tuple(row.shape)} on "
                f"{row.device}")
    if not 0 <= row0 <= height - lh or height * w >= 1 << 31:
        raise ValueError(f"rows [{row0}, {row0 + lh}) must lie in an image "
                         f"of height {height}, and {height} x {w} below "
                         f"2**31 pixels")


def _check_int32(**named) -> None:
    for name, v in named.items():
        if not -(1 << 31) <= v < 1 << 31:
            raise ValueError(f"{name} {v} outside int32")


def _check_counts(counts: torch.Tensor, band: torch.Tensor) -> None:
    tiles = -(-band.shape[1] * band.shape[2] // pee_ops.TILE_PX)
    if counts.dtype != torch.int32 or counts.shape != (band.shape[0], tiles) \
            or counts.device != band.device:
        raise ValueError(
            f"counts must be a (B, tiles) = ({band.shape[0]}, {tiles}) int32 "
            f"tensor on {band.device}, got {counts.dtype} "
            f"{tuple(counts.shape)} on {counts.device}")


@functools.lru_cache(maxsize=None)
def _lib():
    """The kernel library, its tile held to the plain versions'."""
    lib = library()
    if lib.pee_tile_pixels() != pee_ops.TILE_PX:
        raise RuntimeError(f"the kernels' tile of {lib.pee_tile_pixels()} "
                           f"pixels != ops.pee.TILE_PX {pee_ops.TILE_PX}")
    return lib


# ---------------------------------------------------------------------------
# K3: one PEE embed pass
# ---------------------------------------------------------------------------


def pee_embed_plain(imgs, msg, msg_base, want, parity: int, t: int,
                    max_val: int) -> Tuple[torch.Tensor, ...]:
    """Plain torch version of K3: :func:`.pee.embed_pass`."""
    return pee_ops.embed_pass(imgs, msg, msg_base, want, parity, t, max_val)


def _check_msg(msg: torch.Tensor, imgs: torch.Tensor) -> None:
    b = imgs.shape[0]
    if msg.dtype != torch.uint8 or msg.dim() != 2 or msg.shape[0] != b \
            or msg.shape[1] < 1 or msg.device != imgs.device:
        raise ValueError(f"msg must be a (B, L) = ({b}, >=1) uint8 tensor on "
                         f"{imgs.device}, got {msg.dtype} {tuple(msg.shape)}")


def _check_max_val(max_val: int) -> None:
    # bounded by the pixel arithmetic, not by the dtype: a uint8 image with
    # BitsStored > 8 embeds against 2**BitsStored - 1 and wraps past 255,
    # as the JAX package does
    if not 0 <= max_val < 1 << 16:
        raise ValueError(f"max_val {max_val} outside [0, 65535]: the "
                         f"kernels' pixel arithmetic holds 16 bits")


def _on_cuda(t: torch.Tensor, what: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu, not {t.device}")


def pee_embed(
    imgs: torch.Tensor,       # (B, H, W) uint8/uint16
    msg: torch.Tensor,        # (B, L) uint8, one byte per bit, L >= 1
    msg_base: torch.Tensor,   # (B,) int32: first message bit of this pass
    want: torch.Tensor,       # (B,) int32: bits this pass should embed
    parity: int,
    t: int,
    max_val: int,
) -> Tuple[torch.Tensor, ...]:
    """K3: one PEE pass. Returns ``(stego, overflow u8, used, nproc, cap)``
    with ``used = min(want, cap)`` and ``nproc = H*W`` where ``want > cap``
    (see :func:`.pee.embed_pass`). Message indices are clamped to
    ``[0, L)``."""
    _check_images(imgs, "imgs")
    _check_pass(parity, t)
    _check_msg(msg, imgs)
    b, h, w = imgs.shape
    _check_scalars(b, imgs.device, msg_base=msg_base, want=want)
    _check_max_val(max_val)
    if imgs.device.type == "cpu":
        return pee_embed_plain(imgs, msg, msg_base, want, parity, t, max_val)
    _on_cuda(imgs, "pee_embed")
    imgs = imgs.contiguous()
    msg = msg.contiguous()
    msg_base = msg_base.contiguous()
    want = want.contiguous()
    lib = _lib()
    dev = imgs.device
    stego = torch.empty_like(imgs)
    over = torch.empty((b, h, w), dtype=torch.uint8, device=dev)
    # used, nproc and cap, then the ticket and the tiles' status words: the
    # kernel zeroes it all with one memset before its one launch
    scratch = torch.empty(lib.pee_embed_scratch_ints(b, h, w),
                          dtype=torch.int32, device=dev)
    fn = lib.pee_embed_u16 if imgs.dtype == torch.uint16 else lib.pee_embed_u8
    err = fn(
        imgs.data_ptr(), msg.data_ptr(), msg.shape[1], msg_base.data_ptr(),
        want.data_ptr(), b, h, w, parity, t, max_val, stego.data_ptr(),
        over.data_ptr(), scratch.data_ptr(), stream_ptr(imgs),
    )
    check(lib, err, "pee_embed")
    profiling.count("launch.pee_embed")
    used, nproc, cap = scratch[:3 * b].view(3, b)
    return stego, over, used, nproc, cap


# ---------------------------------------------------------------------------
# K3's band mode: a count launch, then an apply launch
# ---------------------------------------------------------------------------


# The plain torch versions of K3's band launches, with the wrappers'
# signatures.
pee_count_band_plain = pee_ops.band_tile_counts
pee_embed_band_plain = pee_ops.embed_pass_band_tiles


def pee_count_band(
    band: torch.Tensor,     # (B, lh, W) uint8/uint16: rows of an image
    top: torch.Tensor,      # (B, W): the row above the band, or its first
    bottom: torch.Tensor,   # (B, W): the row below it, or its last
    row0: int,              # the band's first global row
    height: int,            # the image's rows
    parity: int,
    t: int,
    max_val: int,
) -> torch.Tensor:
    """K3's band count launch: each tile's eligible pixels, ``(B, tiles)``
    int32 (tiles of :data:`.pee.TILE_PX` band pixels; see
    :func:`.pee.band_tile_counts`). A band's row sums to its eligible
    count: the rank prefix of the bands below it."""
    _check_band(band, top, bottom, row0, height)
    _check_pass(parity, t)
    _check_max_val(max_val)
    if band.device.type == "cpu":
        return pee_count_band_plain(band, top, bottom, row0, height, parity,
                                    t, max_val)
    _on_cuda(band, "pee_count_band")
    band, top, bottom = band.contiguous(), top.contiguous(), bottom.contiguous()
    lib = _lib()
    b, lh, w = band.shape
    counts = torch.empty((b, -(-lh * w // pee_ops.TILE_PX)),
                         dtype=torch.int32, device=band.device)
    fn = (lib.pee_count_band_u16 if band.dtype == torch.uint16
          else lib.pee_count_band_u8)
    err = fn(band.data_ptr(), top.data_ptr(), bottom.data_ptr(), row0, b, lh,
             height, w, parity, t, max_val, counts.data_ptr(),
             stream_ptr(band))
    check(lib, err, "pee_count_band")
    profiling.count("launch.pee_count_band")
    return counts


def pee_embed_band(
    band: torch.Tensor,                  # (B, lh, W) uint8/uint16
    top: torch.Tensor,                   # (B, W), as in pee_count_band
    bottom: torch.Tensor,
    row0: int,
    height: int,
    counts: torch.Tensor,                # (B, tiles) int32: pee_count_band's
    rank_base: Optional[torch.Tensor],   # (B,) int32, or None for 0
    msg: torch.Tensor,                   # (B, L) uint8, the whole message
    msg_base: int,                       # this pass's first message bit
    want: int,                           # bits the whole pass should embed
    parity: int,
    t: int,
    max_val: int,
) -> Tuple[torch.Tensor, ...]:
    """K3's band apply launch: one pass over the band, each tile ranked from
    ``rank_base`` (the eligible pixels of the rows above the band) and the
    ``counts`` of the tiles before it. Returns ``(stego, overflow u8,
    nproc)``, ``nproc`` the largest set rank the band processes (0 if
    none; see :func:`.pee.embed_pass_band`); the caller combines the
    bands."""
    _check_band(band, top, bottom, row0, height)
    _check_pass(parity, t)
    _check_msg(msg, band)
    _check_max_val(max_val)
    _check_counts(counts, band)
    _check_int32(msg_base=msg_base, want=want)
    if rank_base is not None:
        _check_scalars(band.shape[0], band.device, rank_base=rank_base)
    if band.device.type == "cpu":
        return pee_embed_band_plain(band, top, bottom, row0, height, counts,
                                    rank_base, msg, msg_base, want, parity,
                                    t, max_val)
    _on_cuda(band, "pee_embed_band")
    band, top, bottom = band.contiguous(), top.contiguous(), bottom.contiguous()
    msg, counts = msg.contiguous(), counts.contiguous()
    if rank_base is not None:
        rank_base = rank_base.contiguous()
    lib = _lib()
    b, lh, w = band.shape
    dev = band.device
    stego = torch.empty_like(band)
    over = torch.empty((b, lh, w), dtype=torch.uint8, device=dev)
    nproc = torch.empty(b, dtype=torch.int32, device=dev)
    fn = (lib.pee_embed_band_u16 if band.dtype == torch.uint16
          else lib.pee_embed_band_u8)
    err = fn(
        band.data_ptr(), msg.data_ptr(), msg.shape[1], msg_base, want,
        top.data_ptr(), bottom.data_ptr(), row0,
        None if rank_base is None else rank_base.data_ptr(),
        counts.data_ptr(), b, lh, height, w, parity, t, max_val,
        stego.data_ptr(), over.data_ptr(), nproc.data_ptr(), stream_ptr(band),
    )
    check(lib, err, "pee_embed_band")
    profiling.count("launch.pee_embed_band")
    return stego, over, nproc


# ---------------------------------------------------------------------------
# K4: invert one PEE pass
# ---------------------------------------------------------------------------


def pee_extract_plain(stego, overflow, nproc, parity: int, t: int,
                      out_len: int) -> Tuple[torch.Tensor, ...]:
    """Plain torch version of K4: :func:`.pee.extract_pass`."""
    return pee_ops.extract_pass(stego, overflow, nproc, parity, t, out_len)


def _check_overflow(overflow: torch.Tensor, stego: torch.Tensor) -> None:
    if overflow.dtype not in (torch.bool, torch.uint8) \
            or overflow.shape != stego.shape or overflow.device != stego.device:
        raise ValueError(
            f"overflow must be a bool/uint8 tensor of shape "
            f"{tuple(stego.shape)} on {stego.device}, got {overflow.dtype} "
            f"{tuple(overflow.shape)}")


def _overflow_bytes(overflow: torch.Tensor) -> torch.Tensor:
    over = overflow.contiguous()
    return over.view(torch.uint8) if over.dtype == torch.bool else over


def pee_extract(
    stego: torch.Tensor,      # (B, H, W) uint8/uint16
    overflow: torch.Tensor,   # (B, H, W) bool/uint8 overflow location map
    nproc: torch.Tensor,      # (B,) int32 pass boundary
    parity: int,
    t: int,
    out_len: int,
) -> Tuple[torch.Tensor, ...]:
    """K4: invert one PEE pass. Returns ``(restored, bits (B, out_len)
    uint8, nbits (B,) int32)``; bits of ranks at or past ``out_len`` are
    dropped (see :func:`.pee.extract_pass`)."""
    _check_images(stego, "stego")
    _check_pass(parity, t)
    b, h, w = stego.shape
    if out_len < 1:
        raise ValueError(f"out_len must be >= 1, got {out_len}")
    _check_overflow(overflow, stego)
    _check_scalars(b, stego.device, nproc=nproc)
    if stego.device.type == "cpu":
        return pee_extract_plain(stego, overflow, nproc, parity, t, out_len)
    _on_cuda(stego, "pee_extract")
    stego = stego.contiguous()
    over = _overflow_bytes(overflow)
    nproc = nproc.contiguous()
    lib = _lib()
    restored = torch.empty_like(stego)
    # nbits, the ticket and the tiles' status words, then the bit rows: the
    # kernel zeroes it all with one memset before its one launch
    nscratch = lib.pee_extract_scratch_bytes(b, h, w)
    buf = torch.empty(nscratch + b * out_len, dtype=torch.uint8,
                      device=stego.device)
    fn = (lib.pee_extract_u16 if stego.dtype == torch.uint16
          else lib.pee_extract_u8)
    err = fn(
        stego.data_ptr(), over.data_ptr(), nproc.data_ptr(), b, h, w, parity,
        t, out_len, restored.data_ptr(), buf.data_ptr(), stream_ptr(stego),
    )
    check(lib, err, "pee_extract")
    profiling.count("launch.pee_extract")
    nbits = buf[:4 * b].view(torch.int32)
    return restored, buf[nscratch:].view(b, out_len), nbits


# ---------------------------------------------------------------------------
# K4's band mode: a count launch, then an apply launch
# ---------------------------------------------------------------------------


# The plain torch version of K4's band count, with the wrapper's signature.
pee_extract_count_band_plain = pee_ops.band_extract_tile_counts


def pee_extract_count_band(
    band: torch.Tensor,       # (B, lh, W) uint8/uint16 stego rows
    top: torch.Tensor,        # (B, W), as in pee_count_band
    bottom: torch.Tensor,
    row0: int,
    height: int,
    overflow: torch.Tensor,   # (B, lh, W) bool/uint8
    nproc: int,               # the pass's global boundary
    parity: int,
    t: int,
) -> torch.Tensor:
    """K4's band count launch: each tile's expanded processed pixels (the
    bits it carries), ``(B, tiles)`` int32 (see
    :func:`.pee.band_extract_tile_counts`)."""
    _check_band(band, top, bottom, row0, height)
    _check_pass(parity, t)
    _check_overflow(overflow, band)
    _check_int32(nproc=nproc)
    if band.device.type == "cpu":
        return pee_extract_count_band_plain(band, top, bottom, row0, height,
                                            overflow, nproc, parity, t)
    _on_cuda(band, "pee_extract_count_band")
    band, top, bottom = band.contiguous(), top.contiguous(), bottom.contiguous()
    over = _overflow_bytes(overflow)
    lib = _lib()
    b, lh, w = band.shape
    counts = torch.empty((b, -(-lh * w // pee_ops.TILE_PX)),
                         dtype=torch.int32, device=band.device)
    fn = (lib.pee_extract_count_band_u16 if band.dtype == torch.uint16
          else lib.pee_extract_count_band_u8)
    err = fn(band.data_ptr(), over.data_ptr(), nproc, top.data_ptr(),
             bottom.data_ptr(), row0, b, lh, height, w, parity, t,
             counts.data_ptr(), stream_ptr(band))
    check(lib, err, "pee_extract_count_band")
    profiling.count("launch.pee_extract_count_band")
    return counts


def _band_row_len(band: torch.Tensor, row0: int, height: int, parity: int,
                  out_len: int) -> int:
    """Bytes of a band's bit row: the most bits it can carry (its in-set
    pixels), at most ``out_len``."""
    return min(out_len, pee_ops.band_set_count(row0, band.shape[1], height,
                                               band.shape[2], parity))


def pee_extract_band_plain(band, top, bottom, row0: int, height: int,
                           overflow, nproc: int, parity: int, t: int,
                           out_len: int) -> Tuple[torch.Tensor, ...]:
    """Plain torch version of K4's band mode: :func:`.pee.extract_pass_band`
    with :func:`pee_extract_band`'s bit row length (0 past ``nbits``)."""
    rows = torch.full((band.shape[0],), row0, dtype=torch.int32,
                      device=band.device)
    return pee_ops.extract_pass_band(
        band, top, bottom, rows, overflow, torch.full_like(rows, nproc),
        parity, t, _band_row_len(band, row0, height, parity, out_len), height)


def pee_extract_band(
    band: torch.Tensor,       # (B, lh, W) uint8/uint16 stego rows
    top: torch.Tensor,        # (B, W), as in pee_count_band
    bottom: torch.Tensor,
    row0: int,
    height: int,
    overflow: torch.Tensor,   # (B, lh, W) bool/uint8
    nproc: int,               # the pass's global boundary
    parity: int,
    t: int,
    out_len: int,
) -> Tuple[torch.Tensor, ...]:
    """K4's band mode: :func:`pee_extract_count_band`, then the apply
    launch. Returns ``(restored, bits (B, R) uint8, nbits (B,) int32)``:
    ``R = min(out_len, the band's in-set pixels)``, the band's bits in band
    rank order from 0, valid up to ``nbits`` (not zeroed past it; the
    caller places a band's bits after the counts of the bands above it)."""
    _check_band(band, top, bottom, row0, height)
    _check_pass(parity, t)
    if out_len < 1:
        raise ValueError(f"out_len must be >= 1, got {out_len}")
    _check_overflow(overflow, band)
    _check_int32(nproc=nproc)
    if band.device.type == "cpu":
        return pee_extract_band_plain(band, top, bottom, row0, height,
                                      overflow, nproc, parity, t, out_len)
    _on_cuda(band, "pee_extract_band")
    counts = pee_extract_count_band(band, top, bottom, row0, height, overflow,
                                    nproc, parity, t)
    band, top, bottom = band.contiguous(), top.contiguous(), bottom.contiguous()
    over = _overflow_bytes(overflow)
    lib = _lib()
    b, lh, w = band.shape
    row_len = _band_row_len(band, row0, height, parity, out_len)
    restored = torch.empty_like(band)
    bits = torch.empty((b, row_len), dtype=torch.uint8, device=band.device)
    nbits = torch.empty(b, dtype=torch.int32, device=band.device)
    fn = (lib.pee_extract_band_u16 if band.dtype == torch.uint16
          else lib.pee_extract_band_u8)
    err = fn(band.data_ptr(), over.data_ptr(), nproc, top.data_ptr(),
             bottom.data_ptr(), row0, counts.data_ptr(), b, lh, height, w,
             parity, t, row_len, restored.data_ptr(), bits.data_ptr(),
             nbits.data_ptr(), stream_ptr(band))
    check(lib, err, "pee_extract_band")
    profiling.count("launch.pee_extract_band")
    return restored, bits, nbits


# ---------------------------------------------------------------------------
# Both passes, chained on the device
# ---------------------------------------------------------------------------


def embed_both_passes(
    img: torch.Tensor,         # (B, H, W)
    msg_bits: torch.Tensor,    # (B, L) uint8
    total_bits: torch.Tensor,  # (B,) int32
    t: int,
    max_val: int,
):
    """Both PEE passes through K3. Returns ``(stego, overflow_map, used0,
    nproc0, used1, nproc1)``.

    Pass 1's base and want are pass 0's device scalars (``used0`` and
    ``total - used0``), so nothing waits on the host between the passes. A
    pass at ``want = 0`` is an exact no-op (nothing is processed), so this
    equals running pass 0 alone when the payload fits there."""
    total = total_bits.to(torch.int32)
    s0, o0, u0, n0, _ = pee_embed(
        img, msg_bits, torch.zeros_like(total), total, 0, t, max_val
    )
    s1, o1, u1, n1, _ = pee_embed(s0, msg_bits, u0, total - u0, 1, t, max_val)
    return s1, o0 | o1, u0, n0, u1, n1


def extract_both_passes(
    stego: torch.Tensor,
    overflow_map: torch.Tensor,
    nproc0: torch.Tensor,      # (B,) int32 (pass-0 boundary)
    nproc1: torch.Tensor,      # (B,) int32 (pass-1 boundary; 0 = no pass 1)
    t: int,
    out_len: int,
):
    """Invert both PEE passes (pass 1 first) through K4. Returns
    ``(restored, bits1, n_bits1, bits0, n_bits0)``. A pass at ``n_proc = 0``
    is an exact identity, so single-pass containers restore exactly."""
    r1, b1, m1 = pee_extract(stego, overflow_map, nproc1, 1, t, out_len)
    r0, b0, m0 = pee_extract(r1, overflow_map, nproc0, 0, t, out_len)
    return r0, b1, m1, b0, m0
