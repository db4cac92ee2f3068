# Port of codec_tcc_tpu/ops/embed.py, raster and block halves plus
# pack_bits_batch: the plain torch versions of the raster embed and extract,
# whose hand-written kernels live in ops/raster_kernels.py, and the block
# embed and extract, which run as torch ops on the image's device.
"""Plain torch raster and block embed / extract and XOR location maps.

All raster strategies compute one function. For every plane ``p < s`` a
pixel ``pos`` whose window offset ``rel = (pos - start_p) mod N`` is below
``len_p`` gets bit ``p`` set to ``msg[off_p + rel]``; extraction reads the
same positions back and places plane ``p``'s window at message offset
``off_p``, later planes overwriting earlier ones where windows alias. The
per-plane triples ``(start, length, msg_offset)`` come from the host-side
:class:`~codec_tcc_tpu_torch.ops.segments.PlanePlan`.

These are the reference formulations of kernels K1 ``raster_embed``
(:func:`embed` + :func:`xor_maps_packed_batch`) and K2 ``raster_extract``
(:func:`extract_message_device`): the wrappers in
:mod:`~codec_tcc_tpu_torch.ops.raster_kernels` run them for CPU tensors and
``chip_smoke.py`` holds the CUDA kernels against them on the card. They run
on any device. ``uint16`` has no shifts in torch, so pixels are widened to
``int32`` for the arithmetic and narrowed back at the end (exact).

Strategy ``block_adaptive`` (:func:`embed_block_adaptive`,
:func:`extract_block_message_device`) fills each plane's window in
variance-ranked tile order instead of raster order. The JAX package runs it
as XLA one-hot matmuls, not as a Pallas kernel, so here it is torch ops.
Every route (single image, container batch, volume, tiled) ranks through
:func:`rank_block_fill`, embeds through :func:`embed_block_adaptive` and
decodes through :func:`extract_block_message`, on the device.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..device import to_device
from ..profiling import count, stage
from . import blocks as block_ops

__all__ = [
    "embed",
    "extract_aligned",
    "assemble_message",
    "assemble_message_device",
    "extract_message_device",
    "embed_block_adaptive",
    "embed_block_batch",
    "rank_block_fill",
    "extract_block_aligned",
    "extract_block_message_device",
    "extract_block_message",
    "xor_maps_packed_batch",
    "pack_bits_batch",
    "expand_bits_tensor",
    "restore_original",
    "pad_message",
]


def embed(
    image: torch.Tensor,          # (H, W) uint8/uint16
    msg_bits: torch.Tensor,       # (L,) uint8 0/1 on the image's device
    plane_start: Sequence[int],   # (nbits,) raster start offset per plane
    seg_len: Sequence[int],       # (nbits,) embedded bits per plane (<= H*W)
    msg_off: Sequence[int],       # (nbits,) message bit offset per plane
    s: int,                       # runtime cut point
    nbits: int,
) -> torch.Tensor:
    """Return the stego image; bit-exact with the JAX package's ``embed``.

    The message is read by index with a bounds check (bits past ``L`` read
    as 0) instead of slicing a buffer padded by :func:`pad_message`; for a
    padded message the two are the same function."""
    h, w = image.shape
    n = h * w
    dev = image.device
    acc = image.reshape(n).to(torch.int32)
    iota = torch.arange(n, dtype=torch.int64, device=dev)
    msg = msg_bits.to(device=dev, dtype=torch.int32)
    L = msg.numel()
    for p in range(nbits):
        ln = int(seg_len[p])
        if p >= s or ln <= 0:
            continue                      # window mask is empty
        rel = iota - int(plane_start[p])
        rel = torch.where(rel < 0, rel + n, rel)
        active = rel < ln
        idx = int(msg_off[p]) + rel
        if L:
            bits = torch.where(idx < L, msg[idx.clamp(max=L - 1)], 0)
        else:
            bits = torch.zeros_like(acc)
        newv = (acc & ~(1 << p)) | (bits << p)
        acc = torch.where(active, newv, acc)
    return acc.to(image.dtype).reshape(h, w)


def extract_aligned(
    stego: torch.Tensor,
    plane_start: Sequence[int],
    seg_len: Sequence[int],
    s: int,
    nbits: int,
) -> torch.Tensor:
    """Extraction front half: ``(nbits, H*W) uint8`` where row p holds
    plane p's bits rotated back to message order and masked to its
    window."""
    h, w = stego.shape
    n = h * w
    flat = stego.reshape(n).to(torch.int32)
    iota = torch.arange(n, dtype=torch.int64, device=stego.device)
    rows = torch.zeros((nbits, n), dtype=torch.uint8, device=stego.device)
    for p in range(nbits):
        if p >= s:
            continue                      # (p < s) mask: row stays zero
        plane = ((flat >> p) & 1).to(torch.uint8)
        aligned = torch.roll(plane, -int(plane_start[p]))
        rows[p] = torch.where(iota < int(seg_len[p]), aligned, 0)
    return rows


def assemble_message(aligned, msg_off, seg_len, out_len: int) -> np.ndarray:
    """Host back half of extraction: copy each plane's window to its message
    offset. ``aligned`` is the (nbits, N) result of :func:`extract_aligned`
    (or (B, nbits, N) for batches, with per-image offset/length arrays)."""
    aligned = np.asarray(aligned)
    if aligned.ndim == 3:
        return np.stack(
            [
                assemble_message(aligned[i], msg_off[i], seg_len[i], out_len)
                for i in range(aligned.shape[0])
            ]
        )
    out = np.zeros(out_len, dtype=np.uint8)
    for p in range(aligned.shape[0]):
        ln = int(seg_len[p])
        off = int(msg_off[p])
        if ln <= 0 or off >= out_len:
            continue
        ln = min(ln, out_len - off)
        out[off : off + ln] = aligned[p, :ln]
    return out


def assemble_message_device(
    aligned: torch.Tensor,        # (P, N) uint8 aligned plane rows
    msg_off: Sequence[int],
    seg_len: Sequence[int],
    out_len: int,
) -> torch.Tensor:
    """Device counterpart of :func:`assemble_message`: only the ``out_len``
    assembled message bits. Later planes OVERWRITE earlier ones where
    windows overlap (the reference's negative-size distribution accident
    can alias two planes onto one offset); any roll wrap-around lands
    outside the window mask."""
    p_planes, n = aligned.shape
    pos = torch.arange(out_len, dtype=torch.int64, device=aligned.device)
    acc = torch.zeros(out_len, dtype=torch.uint8, device=aligned.device)
    for p in range(p_planes):
        row = aligned[p]
        if out_len <= n:
            seg = row[:out_len]
        else:
            seg = torch.cat([row, row.new_zeros(out_len - n)])
        off = int(msg_off[p])
        placed = torch.roll(seg, off)
        rel = pos - off
        acc = torch.where((rel >= 0) & (rel < int(seg_len[p])), placed, acc)
    return acc


def extract_message_device(
    stego: torch.Tensor,
    plane_start: Sequence[int],
    seg_len: Sequence[int],
    msg_off: Sequence[int],
    s: int,
    nbits: int,
    out_len: int,
) -> torch.Tensor:
    """:func:`extract_aligned` + :func:`assemble_message_device`: the
    ``(out_len,)`` payload bits — the plain version of K2."""
    aligned = extract_aligned(stego, plane_start, seg_len, s, nbits)
    return assemble_message_device(aligned, msg_off, seg_len, out_len)


def xor_maps_packed_batch(
    originals: torch.Tensor, stegos: torch.Tensor, nbits: int
) -> torch.Tensor:
    """``(B, nbits, N/8) uint8`` bit-packed XOR location maps, MSB-first
    within each byte so the host inverse is plain ``np.unpackbits``.
    Requires ``H*W % 8 == 0``."""
    b = originals.shape[0]
    diff = (originals.to(torch.int32) ^ stegos.to(torch.int32)).reshape(b, -1)
    n = diff.shape[1]
    sh = torch.arange(nbits, dtype=torch.int32, device=diff.device)
    planes = (diff[:, None, :] >> sh.view(1, nbits, 1)) & 1
    w = 1 << torch.arange(7, -1, -1, dtype=torch.int32, device=diff.device)
    return (
        (planes.view(b, nbits, n // 8, 8) * w).sum(dim=-1).to(torch.uint8)
    )


def pack_bits_batch(bits: torch.Tensor) -> torch.Tensor:
    """``(B, ...)`` 0/1 -> ``(B, ceil(n/8)) uint8``, MSB-first with zero
    padding: per item the bytes of ``np.packbits`` for any length ``n``
    (``H*W % 8 != 0`` included). The PEE encoders pack the overflow
    location maps with it on the device; the packed form is the container
    blob's zlib input."""
    b = bits.shape[0]
    flat = bits.reshape(b, -1).to(torch.int32)
    pad = (-flat.shape[1]) % 8
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    w = 1 << torch.arange(7, -1, -1, dtype=torch.int32, device=flat.device)
    return (flat.view(b, -1, 8) * w).sum(dim=-1).to(torch.uint8)


def expand_bits_tensor(packed: torch.Tensor) -> torch.Tensor:
    """``(..., nb) uint8`` MSB-first packed bytes -> ``(..., nb*8) uint8``
    0/1 bits on their device: :func:`..utils.bits.expand_bits` as torch
    ops, the inverse of :func:`pack_bits_batch`. The PEE decoders expand
    the overflow map with it on a CUDA device."""
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=packed.device)
    return ((packed[..., None] >> shifts) & 1).flatten(-2)


def restore_original(
    stego: torch.Tensor, maps: torch.Tensor, s: int
) -> torch.Tensor:
    """Reversibility: original = stego XOR (maps recombined over the s local
    planes)."""
    nbits = maps.shape[0]
    shifts = torch.arange(nbits, dtype=torch.int32, device=maps.device)
    active = (shifts < s).view(nbits, 1, 1)
    diff = (
        torch.where(active, maps.to(torch.int32), 0) << shifts.view(nbits, 1, 1)
    ).sum(dim=0)
    return (stego.to(torch.int32) ^ diff).to(stego.dtype)


def _block_fill_rank(base, seg_len, s, nbits, h, w, block, row0=0):
    """Yield ``(p, rank)`` for each plane ``p < s`` with a nonempty window:
    ``rank`` is the ``(h*w,) int64`` fill rank of every pixel of rows
    ``row0 .. row0+h-1`` of an image ``w`` wide, in raster order. Pixel
    ``i`` of tile ``t`` at within-tile raster position ``r`` fills at rank
    ``base[p][t] + r``: tiles in variance order, raster within a tile. Edge
    tiles are narrower (``bw_real = min(block, w - x0)``), so ``r`` counts
    within the tile's real width. ``base`` is the ``(nbits, ntiles)`` table
    of :func:`codec_tcc_tpu_torch.ops.blocks.block_bases` on the device."""
    dev = base.device
    y = torch.arange(row0, row0 + h, dtype=torch.int64, device=dev)[:, None]
    x = torch.arange(w, dtype=torch.int64, device=dev)[None, :]
    nw = -(-w // block)
    ty = y // block
    tx = x // block
    x0 = tx * block
    bw_real = torch.clamp(w - x0, max=block)
    tile = (ty * nw + tx).reshape(-1)
    r = ((y - ty * block) * bw_real + (x - x0)).reshape(-1)
    for p in range(min(s, nbits)):
        if int(seg_len[p]) > 0:
            yield p, base[p][tile] + r


def _base_table(base_offsets, device: torch.device) -> torch.Tensor:
    """``(nbits, ntiles)`` tile bases as int64 on ``device``."""
    return to_device(np.asarray(base_offsets), device).to(torch.int64)


def embed_block_adaptive(
    image: torch.Tensor,          # (H, W) uint8/uint16, or a band of rows
    msg_bits: torch.Tensor,       # (L,) uint8 0/1 on the image's device
    base_offsets,                 # (nbits, ntiles) per-plane tile bases
    seg_len: Sequence[int],       # (nbits,) embedded bits per plane
    msg_off: Sequence[int],       # (nbits,) message bit offset per plane
    s: int,                       # runtime cut point
    nbits: int,
    block: int,
    row0: int = 0,                # global row of a band's first row
) -> torch.Tensor:
    """Strategy ``block_adaptive``: variance-ranked block fill, bit-exact
    with the JAX package's ``embed_block_adaptive``.

    One formulation for every geometry. For each plane ``p < s`` a pixel of
    fill rank ``rank = base_p[tile] + r`` below ``len_p`` gets bit ``p`` set
    to ``msg[off_p + rank]``; bits past ``L`` read as 0. The JAX package
    has two routes for this function (a one-hot matmul permutation for
    uniform tilings and a clipped gather for edge tilings); on a message
    padded by :func:`pad_message` both equal this one. The only indexed
    reads are of the int64 base table and of the message. A band of the
    image's rows from global row ``row0`` embeds on its own: a pixel's
    rank depends only on its own tile's base."""
    h, w = image.shape
    n = h * w
    dev = image.device
    base = _base_table(base_offsets, dev)
    acc = image.reshape(n).to(torch.int32)
    msg = msg_bits.to(device=dev, dtype=torch.int32)
    L = msg.numel()
    for p, rank in _block_fill_rank(base, seg_len, s, nbits, h, w, block,
                                    row0):
        idx = int(msg_off[p]) + rank
        if L:
            bits = torch.where(idx < L, msg[idx.clamp(0, L - 1)], 0)
        else:
            bits = torch.zeros_like(acc)
        newv = (acc & ~(1 << p)) | (bits << p)
        acc = torch.where(rank < int(seg_len[p]), newv, acc)
    return acc.to(image.dtype).reshape(h, w)


def rank_block_fill(images, s, seg_len, nbits: int, block: int,
                    device: torch.device) -> np.ndarray:
    """The base table of the block fill of an image or a batch (a host
    array or a tensor), ranked on ``device`` inside the span
    ``block_rank`` (:func:`codec_tcc_tpu_torch.ops.blocks.block_bases`;
    ``s`` and ``seg_len`` per image for a batch), and the fill's counters
    for each image: ``block.tiles_ranked`` the tiles of its ``s`` ranked
    planes, ``block.bits_placed`` the payload bits their windows hold. The
    encode ranks the image, the decode the restored original."""
    with stage("block_rank"):
        bases = block_ops.block_bases(to_device(images, device), s, nbits,
                                      block)
    n = images.shape[-2] * images.shape[-1]
    s_all = np.atleast_1d(s)
    for s_i, len_i in zip(s_all, np.reshape(seg_len, (s_all.size, -1))):
        count("block.tiles_ranked", int(s_i) * bases.shape[-1])
        count("block.bits_placed",
              sum(min(int(len_i[p]), n) for p in range(int(s_i))))
    return bases


def embed_block_batch(images: torch.Tensor, msgs, seg_len, msg_off, s,
                      nbits: int, block: int) -> torch.Tensor:
    """``(B, H, W)`` stegos of the block fill of a batch on its device (the
    container batch's shards and the volume's slices): one base table for
    the batch (:func:`rank_block_fill`), then :func:`embed_block_adaptive`
    per image with its row of ``msgs``, ``seg_len``, ``msg_off`` and
    ``s``."""
    dev = images.device
    bases = rank_block_fill(images, s, seg_len, nbits, block, dev)
    msgs = to_device(msgs, dev)
    return torch.stack([
        embed_block_adaptive(images[i], msgs[i], bases[i], seg_len[i],
                             msg_off[i], int(s[i]), nbits, block)
        for i in range(images.shape[0])
    ])


def extract_block_aligned(
    stego: torch.Tensor,
    base_offsets,
    seg_len: Sequence[int],
    s: int,
    nbits: int,
    block: int,
) -> torch.Tensor:
    """Inverse front half of :func:`embed_block_adaptive`: ``(nbits, H*W)
    uint8`` where row p holds plane p's bits in fill-rank (message) order,
    masked to its window and to ``p < s``, ready for
    :func:`assemble_message_device`.

    Each plane's bits are scattered to their fill ranks. The base rows of
    the planes below ``s`` must come from
    :func:`~codec_tcc_tpu_torch.ops.blocks.block_bases` over the restored
    original, so that the ranks are a permutation of ``0..N-1``, as the
    encoder's were."""
    h, w = stego.shape
    n = h * w
    dev = stego.device
    flat = stego.reshape(n).to(torch.int32)
    base = _base_table(base_offsets, dev)
    iota = torch.arange(n, dtype=torch.int64, device=dev)
    rows = torch.zeros((nbits, n), dtype=torch.uint8, device=dev)
    for p, rank in _block_fill_rank(base, seg_len, s, nbits, h, w, block):
        fill = torch.empty(n, dtype=torch.uint8, device=dev)
        fill[rank] = ((flat >> p) & 1).to(torch.uint8)
        rows[p] = torch.where(iota < int(seg_len[p]), fill, 0)
    return rows


def extract_block_message_device(
    stego: torch.Tensor,
    base_offsets,
    seg_len: Sequence[int],
    msg_off: Sequence[int],
    s: int,
    nbits: int,
    block: int,
    out_len: int,
) -> torch.Tensor:
    """:func:`extract_block_aligned` + :func:`assemble_message_device`:
    the ``(out_len,)`` payload bits on the stego's device. Later planes
    overwrite earlier ones where windows alias, and a plane at or past the
    cut point with a nonzero length writes zeros over its window (its row
    is masked, its window still assembled), as in the JAX package."""
    aligned = extract_block_aligned(stego, base_offsets, seg_len, s, nbits,
                                    block)
    return assemble_message_device(aligned, msg_off, seg_len, out_len)


def extract_block_message(stego, original, seg_len, msg_off, s: int,
                          nbits: int, block: int, out_len: int,
                          device: torch.device) -> torch.Tensor:
    """The ``(out_len,)`` payload bits of a block_adaptive stego (a host
    array or a tensor) on ``device``: the restored ``original`` ranked
    there (:func:`rank_block_fill`), then
    :func:`extract_block_message_device` through that base table. Every
    block decode route reads its payload through this function."""
    bases = rank_block_fill(original, s, seg_len, nbits, block, device)
    if device.type == "cuda":
        count("block.decode_device")
    return extract_block_message_device(
        to_device(stego, device), bases, seg_len, msg_off, s, nbits, block,
        out_len)


def pad_message(msg_bits, n_pixels: int, max_offset: int):
    """Host helper: pad message bits so every ``dynamic_slice(msg, off, N)``
    stays in bounds. Returns a numpy uint8 array of static-friendly length."""
    import numpy as np

    msg_bits = np.asarray(msg_bits, dtype=np.uint8)
    need = max(int(max_offset), 0) + n_pixels
    lpad = max(need, msg_bits.size)
    out = np.zeros(lpad, dtype=np.uint8)
    out[: msg_bits.size] = msg_bits
    return out
