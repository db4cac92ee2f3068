# Port of codec_tcc_tpu/ops/host_extract.py: the same code; only prose differs.
"""Host-side O(payload) extraction (numpy only).

Decode-side stego images are always host-resident: the transport codec is
host code, so extraction starts from a numpy array. The embedding positions
are deterministic windows (raster strategies: ``(start + i) mod N``; block
strategy: variance-ranked tiles scanned raster-within-tile), so the payload
is a handful of numpy slice gathers.

These functions compute exactly what the device formulations in
:mod:`codec_tcc_tpu_torch.ops.embed` compute (same window clamps, same
later-plane-overwrites-earlier assembly as ``assemble_message_device``).
The batch decode of raster containers runs :func:`extract_raster_host`.
No route of the port calls the block functions: every ``block_adaptive``
decode reads its payload on the device
(:func:`codec_tcc_tpu_torch.ops.embed.extract_block_message`), and
``chip_smoke.py`` and the tests hold the device block extract against
:func:`extract_block_host`.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

__all__ = [
    "extract_raster_host",
    "extract_block_host",
    "block_counts_host",
    "block_fill_positions_host",
]


def extract_raster_host(
    stego: np.ndarray,
    starts: Sequence[int],
    lengths: Sequence[int],
    offsets: Sequence[int],
    s: int,
    out_len: int,
) -> np.ndarray:
    """Bit-exact host twin of ``ops.embed.extract_message_device``:
    ``out[off_p + m] = ((stego.ravel()[(start_p + m) % N] >> p) & 1)`` for
    ``m < len_p``, planes applied in ascending order (later planes overwrite
    earlier where the reference's negative-size accidents alias windows).
    Degenerate plans keep the device semantics exactly: a window whose
    length exceeds N — or a plane past the cut point with a nonzero length
    — writes ZEROS over the out-of-range stretch (the device rows are
    zero there), it does not skip it."""
    flat = np.ascontiguousarray(stego).ravel()
    n = flat.size
    out = np.zeros(out_len, dtype=np.uint8)
    for p in range(len(lengths)):
        seg_len = int(lengths[p])
        off = int(offsets[p])
        if seg_len <= 0 or off >= out_len:
            continue
        ln_write = min(seg_len, out_len - off)          # assemble clamp
        ln_bits = min(ln_write, n) if p < int(s) else 0  # row validity mask
        if ln_bits > 0:
            start = int(starts[p]) % n
            end = start + ln_bits
            if end <= n:
                window = flat[start:end]
            else:
                window = np.concatenate([flat[start:], flat[: end - n]])
            out[off : off + ln_bits] = (window >> p) & 1
        if ln_write > ln_bits:
            out[off + ln_bits : off + ln_write] = 0
    return out


def block_counts_host(
    image: np.ndarray, nplanes: int, block: int
) -> np.ndarray:
    """numpy twin of ``ops.blocks.block_bit_counts_all`` (same zero-padding
    to tile multiples): ``(nplanes, ceil(H/b), ceil(W/b)) int32``."""
    h, w = image.shape
    nh = -(-h // block)
    nw = -(-w // block)
    padded = np.zeros((nh * block, nw * block), dtype=image.dtype)
    padded[:h, :w] = image
    out = np.empty((nplanes, nh, nw), dtype=np.int32)
    for p in range(nplanes):
        bits = (padded >> p) & 1
        out[p] = bits.reshape(nh, block, nw, block).sum(
            axis=(1, 3), dtype=np.int32
        )
    return out


def block_fill_positions_host(
    h: int, w: int, block: int, ranking: Sequence[int], num: int
) -> np.ndarray:
    """Raster pixel indices of the first ``num`` fill positions when tiles
    are visited in ``ranking`` order and scanned raster-within-tile — the
    oracle's ``block_fill_positions`` driven by an explicit ranking. O(num)."""
    nw = -(-w // block)
    pos = np.empty(max(num, 0), dtype=np.int64)
    filled = 0
    for t in ranking:
        if filled >= num:
            break
        ty, tx = divmod(int(t), nw)
        y0, x0 = ty * block, tx * block
        bh = min(block, h - y0)
        bw = min(block, w - x0)
        take = min(bh * bw, num - filled)
        r = np.arange(take, dtype=np.int64)
        pos[filled : filled + take] = (y0 + r // bw) * w + (x0 + r % bw)
        filled += take
    return pos[:filled]


def extract_block_host(
    stego: np.ndarray,
    rankings: List[Sequence[int]],       # per-plane variance rankings
    lengths: Sequence[int],
    offsets: Sequence[int],
    s: int,
    block: int,
    out_len: int,
) -> np.ndarray:
    """Bit-exact host twin of ``ops.embed.extract_block_message_device``:
    plane p's bits are read at its first ``len_p`` fill positions (tiles in
    ``rankings[p]`` order) and placed at its message offset. ``rankings``
    come from :func:`codec_tcc_tpu_torch.ops.blocks.ranking_from_counts`
    over the RESTORED original's planes (stego ^ XOR map), matching the
    encoder. Same degenerate-plan zero-fill semantics as
    :func:`extract_raster_host`."""
    h, w = stego.shape
    flat = np.ascontiguousarray(stego).ravel()
    n = flat.size
    out = np.zeros(out_len, dtype=np.uint8)
    for p in range(len(lengths)):
        seg_len = int(lengths[p])
        off = int(offsets[p])
        if seg_len <= 0 or off >= out_len:
            continue
        ln_write = min(seg_len, out_len - off)
        ln_bits = min(ln_write, n) if p < int(s) else 0
        if ln_bits > 0:
            pos = block_fill_positions_host(h, w, block, rankings[p], ln_bits)
            out[off : off + ln_bits] = (flat[pos] >> p) & 1
        if ln_write > ln_bits:
            out[off + ln_bits : off + ln_write] = 0
    return out
