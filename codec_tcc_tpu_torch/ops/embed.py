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
as XLA one-hot matmuls, not as a Pallas kernel, so here it is torch ops;
the encoder runs the embed on the device, the decoder extracts on the host
(:mod:`.host_extract`), as the JAX package does.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "embed",
    "extract_aligned",
    "assemble_message",
    "assemble_message_device",
    "extract_message_device",
    "embed_block_adaptive",
    "extract_block_aligned",
    "extract_block_message_device",
    "xor_maps_packed_batch",
    "pack_bits_batch",
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


def _block_fill_rank(
    h: int, w: int, block: int, device: torch.device
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tile id and within-tile raster rank of every pixel, ``(N,) int64``
    each, in raster order. A plane with per-tile base offsets ``base``
    (:func:`codec_tcc_tpu_torch.ops.blocks.block_base_offsets`) fills pixel
    ``i`` at rank ``base[tile[i]] + r[i]``: tiles in variance order, raster
    within a tile. Edge tiles are narrower (``bw_real = min(block, w -
    x0)``), so ``r`` counts within the tile's real width."""
    y = torch.arange(h, dtype=torch.int64, device=device)[:, None]
    x = torch.arange(w, dtype=torch.int64, device=device)[None, :]
    nw = -(-w // block)
    ty = y // block
    tx = x // block
    x0 = tx * block
    bw_real = torch.clamp(w - x0, max=block)
    tile = ty * nw + tx
    r = (y - ty * block) * bw_real + (x - x0)
    return tile.reshape(-1), r.reshape(-1)


def _base_table(base_offsets, device: torch.device) -> torch.Tensor:
    """``(nbits, ntiles)`` tile bases as int64 on ``device``."""
    return torch.as_tensor(np.asarray(base_offsets)).to(
        device=device, dtype=torch.int64
    )


def embed_block_adaptive(
    image: torch.Tensor,          # (H, W) uint8/uint16
    msg_bits: torch.Tensor,       # (L,) uint8 0/1 on the image's device
    base_offsets,                 # (nbits, ntiles) per-plane tile bases
    seg_len: Sequence[int],       # (nbits,) embedded bits per plane
    msg_off: Sequence[int],       # (nbits,) message bit offset per plane
    s: int,                       # runtime cut point
    nbits: int,
    block: int,
) -> torch.Tensor:
    """Strategy ``block_adaptive``: variance-ranked block fill, bit-exact
    with the JAX package's ``embed_block_adaptive``.

    One formulation for every geometry. For each plane ``p < s`` a pixel of
    fill rank ``rank = base_p[tile] + r`` below ``len_p`` gets bit ``p`` set
    to ``msg[off_p + rank]``; bits past ``L`` read as 0. The JAX package
    has two routes for this function (a one-hot matmul permutation for
    uniform tilings and a clipped gather for edge tiles); on a message
    padded by :func:`pad_message` both equal this one. The only indexed
    reads are of the int64 base table and of the message."""
    h, w = image.shape
    n = h * w
    dev = image.device
    tile, r = _block_fill_rank(h, w, block, dev)
    base = _base_table(base_offsets, dev)
    acc = image.reshape(n).to(torch.int32)
    msg = msg_bits.to(device=dev, dtype=torch.int32)
    L = msg.numel()
    for p in range(nbits):
        ln = int(seg_len[p])
        if p >= s or ln <= 0:
            continue                      # no pixel of the plane is active
        rank = base[p][tile] + r
        idx = int(msg_off[p]) + rank
        if L:
            bits = torch.where(idx < L, msg[idx.clamp(0, L - 1)], 0)
        else:
            bits = torch.zeros_like(acc)
        newv = (acc & ~(1 << p)) | (bits << p)
        acc = torch.where(rank < ln, newv, acc)
    return acc.to(image.dtype).reshape(h, w)


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
    :func:`~codec_tcc_tpu_torch.ops.blocks.block_base_offsets` over the
    restored original's planes, so that the ranks are a permutation of
    ``0..N-1``, as the encoder's were."""
    h, w = stego.shape
    n = h * w
    dev = stego.device
    flat = stego.reshape(n).to(torch.int32)
    tile, r = _block_fill_rank(h, w, block, dev)
    base = _base_table(base_offsets, dev)
    iota = torch.arange(n, dtype=torch.int64, device=dev)
    rows = torch.zeros((nbits, n), dtype=torch.uint8, device=dev)
    for p in range(nbits):
        ln = int(seg_len[p])
        if p >= s or ln <= 0:
            continue                      # masked: the row stays zero
        fill = torch.empty(n, dtype=torch.uint8, device=dev)
        fill[base[p][tile] + r] = ((flat >> p) & 1).to(torch.uint8)
        rows[p] = torch.where(iota < ln, fill, 0)
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
