"""Hand-written CUDA kernels of the PEE path, their wrappers and counts.

* **K3** :func:`pee_embed` (``csrc/pee_embed.cu``) — one prediction-error
  expansion pass over a batch of images. Replaces the Pallas
  ``_embed_call``/``_embed_kernel`` of ``codec_tcc_tpu/ops/pallas_pee.py``.
* **K4** :func:`pee_extract` (``csrc/pee_extract.cu``) — its inverse, with
  the bits in message order. Replaces ``_extract_call``/``_extract_kernel``
  and the host join of their per-tile segments (``collect_bits``).

:func:`embed_both_passes` and :func:`extract_both_passes` chain two calls of
a wrapper, pass 1's base and budget taken from pass 0's device results.

Both wrappers take ``shard=``: the kernel's shard mode, one band of rows of
a larger image per batch entry (the counterpart of the Pallas kernels'
``pos_base``/``rank_base``, reached there through
``embed_pass_batch(shard=...)``/``extract_pass_batch(shard=...)``). Its
plain versions are :func:`.pee.embed_pass_band` and
:func:`.pee.extract_pass_band`; :mod:`..parallel.tile_pee` is its caller.

Both kernels take a batch: images ``(B, H, W)`` of any geometry with
per-image ``(B,)`` int32 tensors on the same device, so a pass's base and
budget can be the previous pass's device results. A wrapper given CUDA tensors
launches its kernel on the current stream or raises; given CPU tensors it
runs the plain torch version from :mod:`.pee`. Nothing falls back from the
kernel to the plain version. The kernels are built with the raster kernels
into one library (:mod:`.kernel_library`).

:data:`LAUNCHES` counts wrapper calls that launched a kernel; plain-version
calls do not count. A call of either wrapper is one memset and ONE kernel
launch: the tiles' global ranks come from a decoupled look-back
(``csrc/pee_common.cuh``). K3's memset zeroes its scratch, K4's its scratch
and the bit rows, which share one allocation. Shard-mode launches count
under ``pee_embed_shard`` and ``pee_extract_shard``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import pee as pee_ops
from .kernel_library import check, library, stream_ptr

__all__ = [
    "LAUNCHES",
    "embed_both_passes",
    "extract_both_passes",
    "pee_embed",
    "pee_embed_plain",
    "pee_extract",
    "pee_extract_plain",
    "reset_launch_counts",
]

LAUNCHES = {"pee_embed": 0, "pee_extract": 0, "pee_embed_shard": 0,
            "pee_extract_shard": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


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


def _check_band(band: torch.Tensor, top, bottom, height: int,
                **scalars) -> None:
    """A shard-mode band: ``top``/``bottom`` ``(B, W)`` rows of its dtype on
    its device, ``(B,)`` int32 scalars, and a height that holds it."""
    b, lh, w = band.shape
    for name, row in (("top", top), ("bottom", bottom)):
        if row.dtype != band.dtype or row.shape != (b, w) \
                or row.device != band.device:
            raise ValueError(
                f"{name} must be a (B, W) = ({b}, {w}) {band.dtype} tensor "
                f"on {band.device}, got {row.dtype} {tuple(row.shape)} on "
                f"{row.device}")
    _check_scalars(b, band.device, **scalars)
    if not lh <= height or height * w >= 1 << 31:
        raise ValueError(f"height {height} must hold the band's {lh} rows "
                         f"and keep {height} x {w} below 2**31 pixels")


# ---------------------------------------------------------------------------
# K3: one PEE embed pass
# ---------------------------------------------------------------------------


def pee_embed_plain(imgs, msg, msg_base, want, parity: int, t: int,
                    max_val: int, *, shard=None) -> Tuple[torch.Tensor, ...]:
    """Plain torch version of K3: :func:`.pee.embed_pass`, or with
    ``shard=(top, bottom, row0, rank_base, height)``
    :func:`.pee.embed_pass_band`."""
    if shard is not None:
        top, bottom, row0, rank_base, height = shard
        return pee_ops.embed_pass_band(imgs, top, bottom, row0, rank_base,
                                       msg, msg_base, want, parity, t,
                                       max_val, height)
    return pee_ops.embed_pass(imgs, msg, msg_base, want, parity, t, max_val)


def pee_embed(
    imgs: torch.Tensor,       # (B, H, W) uint8/uint16
    msg: torch.Tensor,        # (B, L) uint8, one byte per bit, L >= 1
    msg_base: torch.Tensor,   # (B,) int32: first message bit of this pass
    want: torch.Tensor,       # (B,) int32: bits this pass should embed
    parity: int,
    t: int,
    max_val: int,
    *,
    shard=None,
) -> Tuple[torch.Tensor, ...]:
    """K3: one PEE pass. Returns ``(stego, overflow u8, used, nproc, cap)``
    with ``used = min(want, cap)`` and ``nproc = H*W`` where ``want > cap``
    (see :func:`.pee.embed_pass`). Message indices are clamped to
    ``[0, L)``.

    ``shard=(top, bottom, row0, rank_base, height)`` runs the shard mode:
    ``imgs`` is then one band of rows per image of an image ``height`` rows
    tall, ``top``/``bottom`` ``(B, W)`` the rows above and below it (its own
    edge rows at the image's border), ``row0`` and ``rank_base`` ``(B,)``
    int32 its first global row and the eligible count of the rows above
    it, and ``want`` the whole pass's budget. Returns ``(stego, overflow
    u8, count, nproc)``, the band's eligible count and largest processed
    set rank (see :func:`.pee.embed_pass_band`); the caller combines the
    bands."""
    _check_images(imgs, "imgs")
    _check_pass(parity, t)
    b, h, w = imgs.shape
    if msg.dtype != torch.uint8 or msg.dim() != 2 or msg.shape[0] != b \
            or msg.shape[1] < 1 or msg.device != imgs.device:
        raise ValueError(f"msg must be a (B, L) = ({b}, >=1) uint8 tensor on "
                         f"{imgs.device}, got {msg.dtype} {tuple(msg.shape)}")
    _check_scalars(b, imgs.device, msg_base=msg_base, want=want)
    # bounded by the pixel arithmetic, not by the dtype: a uint8 image with
    # BitsStored > 8 embeds against 2**BitsStored - 1 and wraps past 255,
    # as the JAX package does
    if not 0 <= max_val < 1 << 16:
        raise ValueError(f"max_val {max_val} outside [0, 65535]: the "
                         f"kernels' pixel arithmetic holds 16 bits")
    if shard is not None:
        top, bottom, row0, rank_base, height = shard
        _check_band(imgs, top, bottom, height, row0=row0,
                    rank_base=rank_base)
    if imgs.device.type == "cpu":
        return pee_embed_plain(imgs, msg, msg_base, want, parity, t, max_val,
                               shard=shard)
    if imgs.device.type != "cuda":
        raise ValueError(f"pee_embed runs on cuda or cpu, not {imgs.device}")
    imgs = imgs.contiguous()
    msg = msg.contiguous()
    msg_base = msg_base.contiguous()
    want = want.contiguous()
    lib = library()
    dev = imgs.device
    stego = torch.empty_like(imgs)
    over = torch.empty((b, h, w), dtype=torch.uint8, device=dev)
    # used, nproc and cap, then the ticket and the tiles' status words: the
    # kernel zeroes it all with one memset before its one launch
    scratch = torch.empty(lib.pee_embed_scratch_ints(b, h, w),
                          dtype=torch.int32, device=dev)
    u16 = imgs.dtype == torch.uint16
    if shard is None:
        fn = lib.pee_embed_u16 if u16 else lib.pee_embed_u8
        err = fn(
            imgs.data_ptr(), msg.data_ptr(), msg.shape[1],
            msg_base.data_ptr(), want.data_ptr(), b, h, w, parity, t,
            max_val, stego.data_ptr(), over.data_ptr(), scratch.data_ptr(),
            stream_ptr(imgs),
        )
        check(lib, err, "pee_embed")
        LAUNCHES["pee_embed"] += 1
        used, nproc, cap = scratch[:3 * b].view(3, b)
        return stego, over, used, nproc, cap
    top, bottom = top.contiguous(), bottom.contiguous()
    row0, rank_base = row0.contiguous(), rank_base.contiguous()
    fn = lib.pee_embed_band_u16 if u16 else lib.pee_embed_band_u8
    err = fn(
        imgs.data_ptr(), msg.data_ptr(), msg.shape[1], msg_base.data_ptr(),
        want.data_ptr(), top.data_ptr(), bottom.data_ptr(), row0.data_ptr(),
        rank_base.data_ptr(), b, h, height, w, parity, t, max_val,
        stego.data_ptr(), over.data_ptr(), scratch.data_ptr(),
        stream_ptr(imgs),
    )
    check(lib, err, "pee_embed (shard mode)")
    LAUNCHES["pee_embed_shard"] += 1
    _, nproc, count = scratch[:3 * b].view(3, b)
    return stego, over, count, nproc


# ---------------------------------------------------------------------------
# K4: invert one PEE pass
# ---------------------------------------------------------------------------


def pee_extract_plain(stego, overflow, nproc, parity: int, t: int,
                      out_len: int, *, shard=None) -> Tuple[torch.Tensor, ...]:
    """Plain torch version of K4: :func:`.pee.extract_pass`, or with
    ``shard=(top, bottom, row0, height)`` :func:`.pee.extract_pass_band`."""
    if shard is not None:
        top, bottom, row0, height = shard
        return pee_ops.extract_pass_band(stego, top, bottom, row0, overflow,
                                         nproc, parity, t, out_len, height)
    return pee_ops.extract_pass(stego, overflow, nproc, parity, t, out_len)


def pee_extract(
    stego: torch.Tensor,      # (B, H, W) uint8/uint16
    overflow: torch.Tensor,   # (B, H, W) bool/uint8 overflow location map
    nproc: torch.Tensor,      # (B,) int32 pass boundary
    parity: int,
    t: int,
    out_len: int,
    *,
    shard=None,
) -> Tuple[torch.Tensor, ...]:
    """K4: invert one PEE pass. Returns ``(restored, bits (B, out_len)
    uint8, nbits (B,) int32)``; bits of ranks at or past ``out_len`` are
    dropped (see :func:`.pee.extract_pass`).

    ``shard=(top, bottom, row0, height)`` runs the shard mode on one band
    of rows per image (as in :func:`pee_embed`), ``nproc`` the pass's
    global boundary: the bits are the band's, in band rank order from 0,
    and ``nbits`` their count (see :func:`.pee.extract_pass_band`)."""
    _check_images(stego, "stego")
    _check_pass(parity, t)
    b, h, w = stego.shape
    if out_len < 1:
        raise ValueError(f"out_len must be >= 1, got {out_len}")
    if overflow.dtype not in (torch.bool, torch.uint8) \
            or overflow.shape != stego.shape or overflow.device != stego.device:
        raise ValueError(
            f"overflow must be a bool/uint8 tensor of shape "
            f"{tuple(stego.shape)} on {stego.device}, got {overflow.dtype} "
            f"{tuple(overflow.shape)}")
    _check_scalars(b, stego.device, nproc=nproc)
    if shard is not None:
        top, bottom, row0, height = shard
        _check_band(stego, top, bottom, height, row0=row0)
    if stego.device.type == "cpu":
        return pee_extract_plain(stego, overflow, nproc, parity, t, out_len,
                                 shard=shard)
    if stego.device.type != "cuda":
        raise ValueError(f"pee_extract runs on cuda or cpu, not {stego.device}")
    stego = stego.contiguous()
    over = overflow.contiguous()
    if over.dtype == torch.bool:
        over = over.view(torch.uint8)
    nproc = nproc.contiguous()
    lib = library()
    restored = torch.empty_like(stego)
    # nbits, the ticket and the tiles' status words, then the bit rows: the
    # kernel zeroes it all with one memset before its one launch
    nscratch = lib.pee_extract_scratch_bytes(b, h, w)
    buf = torch.empty(nscratch + b * out_len, dtype=torch.uint8,
                      device=stego.device)
    u16 = stego.dtype == torch.uint16
    if shard is None:
        fn = lib.pee_extract_u16 if u16 else lib.pee_extract_u8
        err = fn(
            stego.data_ptr(), over.data_ptr(), nproc.data_ptr(), b, h, w,
            parity, t, out_len, restored.data_ptr(), buf.data_ptr(),
            stream_ptr(stego),
        )
        check(lib, err, "pee_extract")
        LAUNCHES["pee_extract"] += 1
    else:
        top, bottom, row0 = (top.contiguous(), bottom.contiguous(),
                             row0.contiguous())
        fn = lib.pee_extract_band_u16 if u16 else lib.pee_extract_band_u8
        err = fn(
            stego.data_ptr(), over.data_ptr(), nproc.data_ptr(),
            top.data_ptr(), bottom.data_ptr(), row0.data_ptr(), b, h, height,
            w, parity, t, out_len, restored.data_ptr(), buf.data_ptr(),
            stream_ptr(stego),
        )
        check(lib, err, "pee_extract (shard mode)")
        LAUNCHES["pee_extract_shard"] += 1
    nbits = buf[:4 * b].view(torch.int32)
    return restored, buf[nscratch:].view(b, out_len), nbits


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
