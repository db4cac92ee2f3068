# Port of codec_tcc_tpu/parallel/tile.py on a mesh of torch devices.
# TileParams, shard_windows, shard_rows, assemble_tiled and
# _host_block_geometry are copies of the originals; the per-band embed and
# extract (XLA in the JAX package, no Pallas) are torch ops on the band's
# device. Rows split as the JAX package's do (shard_rows), but the last
# bands are shorter or empty instead of zero-padded: no pixel, window or
# byte depends on the padding.
"""Spatial (``tile``) sharding: one large image split across the mesh.

The rows of one image split over the mesh's ``tile`` axis, band ``k``
holding rows ``[k*lh, (k+1)*lh)`` (``lh = shard_rows(H, K)``, the last
bands shorter or empty) on the ``k``-th device along the axis. No pixel
moves between bands:

* A plane's active region is a ring interval ``[start, start+len) mod n``
  in global raster order. Its intersection with one band's contiguous
  index range is at most **two** linear windows, so the embedding plan
  resolves on the host into per-band ``(plane, local_start, len,
  msg_offset)`` window tables (:func:`shard_windows`), and each band
  writes only its own windows.
* The payload bits are copied to each band's device.
* The only reductions are the per-band value histograms for the cut point
  and the per-band quality moments, summed on the host.
* Extraction mirrors embedding: each band emits its windows' bits in
  message order; placing them at their message offsets is host work
  (:func:`assemble_tiled`).

Containers are byte-identical to the single-device encoder's
(:func:`codec_tcc_tpu_torch.pipeline.encode_array`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from ..config import EncodeConfig
from ..io import container as container_io
from ..io.codecs import get as get_codec
from ..ops import decompose as decompose_ops
from ..ops import embed as embed_ops
from ..ops import histogram as hist_ops
from ..ops import metrics as metric_ops
from ..ops import segments as segment_ops
from ..utils.logging import get_logger
from .mesh import Mesh

logger = get_logger("parallel.tile")

__all__ = [
    "TileParams",
    "shard_windows",
    "shard_rows",
    "split_rows",
    "join_rows",
    "embed_tiled",
    "extract_tiled_aligned",
    "assemble_tiled",
    "histogram_tiled",
    "pair_stats_tiled",
    "encode_array_tiled",
    "decode_container_tiled",
]

# A row-split image: band k is a (rows_k, W) tensor on the k-th device of
# the mesh axis (see split_rows).
Bands = List[torch.Tensor]


# Copy of codec_tcc_tpu/parallel/tile.py::TileParams (numpy only).
@dataclass(frozen=True)
class TileParams:
    """Per-shard window tables: arrays are ``(n_shards, nwin) int32``."""

    n_shards: int
    nwin: int
    local_n: int                # flat pixels per shard
    plane_id: np.ndarray
    starts: np.ndarray          # local raster start within the shard
    lens: np.ndarray
    moffs: np.ndarray           # message bit offset of the window's first bit


# Copy of codec_tcc_tpu/parallel/tile.py::shard_windows (numpy only).
def shard_windows(
    pp: segment_ops.PlanePlan, n: int, n_shards: int,
    local_n: Optional[int] = None,
) -> TileParams:
    """Resolve a :class:`PlanePlan` into per-shard windows.

    A plane's ring interval ``[start, start+len) mod n`` splits into at most
    two linear intervals; each intersects a shard's contiguous range in at
    most one window — so ``nwin = 2 * s`` bounds the table width (padded to
    ``2 * nbits`` for shape stability across cut points).

    ``local_n`` is the flat size each shard holds (``shard_rows(h, K) *
    w``); the ring arithmetic stays mod the REAL ``n``, so the short or
    empty last shards simply receive fewer or no windows.
    """
    if local_n is None:
        if n % n_shards:
            raise ValueError(
                f"flat size {n} not divisible by {n_shards} shards "
                f"(pass the padded local_n)"
            )
        local_n = n // n_shards
    nwin = 2 * pp.nbits
    k_shape = (n_shards, nwin)
    plane_id = np.zeros(k_shape, np.int32)
    starts = np.zeros(k_shape, np.int32)
    lens = np.zeros(k_shape, np.int32)
    moffs = np.zeros(k_shape, np.int32)
    for k in range(n_shards):
        base, top = k * local_n, (k + 1) * local_n
        j = 0
        for p in range(pp.s):
            st = int(pp.starts[p]) % n
            ln = min(int(pp.lengths[p]), n)
            mo = int(pp.offsets[p])
            if ln <= 0:
                continue
            # (global_start, global_end, bits consumed before this interval)
            if st + ln <= n:
                intervals = ((st, st + ln, 0),)
            else:
                intervals = ((st, n, 0), (0, st + ln - n, n - st))
            for a, b, consumed in intervals:
                lo, hi = max(a, base), min(b, top)
                if lo >= hi:
                    continue
                plane_id[k, j] = p
                starts[k, j] = lo - base
                lens[k, j] = hi - lo
                moffs[k, j] = mo + consumed + (lo - a)
                j += 1
    return TileParams(n_shards, nwin, local_n, plane_id, starts, lens, moffs)


# Copy of codec_tcc_tpu/parallel/tile.py::shard_rows.
def shard_rows(h: int, n_shards: int) -> int:
    """Rows per shard after ceil-padding to an even row split."""
    return -(-h // n_shards)


def split_rows(image, mesh: Mesh, axis: str = "tile") -> Bands:
    """Split a 2-D image's rows over ``mesh``'s ``axis``: band ``k`` holds
    rows ``[k*lh, (k+1)*lh)`` (``lh = shard_rows(h, K)``; the last bands
    are shorter or empty) on the ``k``-th device along the axis. A list of
    bands passes through unchanged."""
    if isinstance(image, (list, tuple)):
        return list(image)
    devices = mesh.axis_devices(axis)
    h = int(image.shape[0])
    lh = shard_rows(h, len(devices))
    bands = []
    for k, dev in enumerate(devices):
        rows = image[min(k * lh, h):min((k + 1) * lh, h)]
        if isinstance(rows, torch.Tensor):
            bands.append(rows.to(dev).contiguous())
        else:
            bands.append(torch.from_numpy(np.ascontiguousarray(rows)).to(dev))
    return bands


def join_rows(bands: Bands) -> np.ndarray:
    """The host image of a row-split image (:func:`split_rows`)."""
    return np.concatenate([band.cpu().numpy() for band in bands])


def _on_devices(arr: np.ndarray, bands: Bands) -> Dict[torch.device, torch.Tensor]:
    """One copy of a host array per distinct device of the bands."""
    out: Dict[torch.device, torch.Tensor] = {}
    for band in bands:
        if band.device not in out:
            out[band.device] = torch.from_numpy(
                np.ascontiguousarray(arr)).to(band.device)
    return out


def _embed_block(block, msg, plane_id, starts, lens, moffs):
    """Window embed on one band's ``(rows, W)`` block: the JAX package's
    roll-and-mask program, with each window's bits written in place. A
    window of :func:`shard_windows` lies inside its band (``start + len <=
    local_n``), so the ring roll is a plain slice; later windows overwrite
    earlier ones, as in the JAX loop."""
    hh, ww = block.shape
    x = block.reshape(hh * ww).to(torch.int32)
    for j in range(len(plane_id)):
        ln = int(lens[j])
        if ln <= 0:
            continue
        p, st, mo = int(plane_id[j]), int(starts[j]), int(moffs[j])
        seg = msg[mo:mo + ln].to(torch.int32)
        x[st:st + ln] = (x[st:st + ln] & ~(1 << p)) | (seg << p)
    return x.reshape(hh, ww).to(block.dtype)


def _extract_block(block, plane_id, starts, lens):
    """Mirror of :func:`_embed_block`: ``(nwin, rows * W)`` uint8, row ``j``
    holding window ``j``'s bits in message order, zero past its length."""
    hh, ww = block.shape
    n_loc = hh * ww
    flat = block.reshape(n_loc).to(torch.int32)
    rows = torch.zeros((len(plane_id), n_loc), dtype=torch.uint8,
                       device=block.device)
    for j in range(len(plane_id)):
        ln = int(lens[j])
        if ln <= 0:
            continue
        st = int(starts[j])
        rows[j, :ln] = ((flat[st:st + ln] >> int(plane_id[j])) & 1).to(
            torch.uint8)
    return rows


def _block_embed_band(band, msg, bases, seg_len, moffs, s, row0, nbits, block):
    """Variance-ranked block embed on one band: the same per-pixel rank
    compare as :func:`..ops.embed.embed_block_adaptive`, with the rank
    formula evaluated at GLOBAL row coordinates (``row0`` = the band's
    first global row). ``bases`` (per-plane tile base offsets) and ``msg``
    are whole: the rank of a band pixel depends only on its own tile's
    base, so no band reads another."""
    hh, ww = band.shape
    dev = band.device
    lpad = msg.shape[0]
    y = torch.arange(hh, dtype=torch.int64, device=dev)[:, None] + row0
    x = torch.arange(ww, dtype=torch.int64, device=dev)[None, :]
    nw = -(-ww // block)
    ty = y // block
    tx = x // block
    tile_id = ty * nw + tx
    x0 = tx * block
    bw_real = torch.clamp(ww - x0, max=block)
    r = (y - ty * block) * bw_real + (x - x0)
    base = torch.as_tensor(np.asarray(bases)).to(device=dev,
                                                 dtype=torch.int64)
    acc = band.to(torch.int32)
    for p in range(nbits):
        if p >= s or int(seg_len[p]) <= 0:
            continue                      # no pixel of the plane is active
        rank = base[p][tile_id] + r
        midx = (int(moffs[p]) + rank).clamp(0, lpad - 1)
        bits = msg[midx].to(torch.int32)
        newv = (acc & ~(1 << p)) | (bits << p)
        acc = torch.where(rank < int(seg_len[p]), newv, acc)
    return acc.to(band.dtype)


# Copy of codec_tcc_tpu/parallel/tile.py::_host_block_geometry (numpy only).
def _host_block_geometry(h: int, w: int, block: int):
    """Plane-invariant half of ``ops.embed._block_fill_rank`` on host:
    ``(tile_id, r)`` flat arrays — per plane, ``rank = base[tile_id] + r``.
    Computed once per decode (the geometry does not depend on the plane),
    so the per-plane cost is one gather + one O(n) inverse permutation."""
    yy, xx = np.mgrid[0:h, 0:w]
    nw = -(-w // block)
    ty, tx = yy // block, xx // block
    x0 = tx * block
    bw = np.minimum(block, w - x0)
    r = (yy - ty * block) * bw + (xx - x0)
    return (ty * nw + tx).reshape(h * w), r.reshape(h * w)


def embed_tiled(
    image, msg_pad: np.ndarray, tp: TileParams, mesh: Mesh,
    axis: str = "tile",
) -> Bands:
    """Embed into a row-split image (a host image or its bands). Returns
    the stego bands, each on its band's device; no band reads another."""
    bands = split_rows(image, mesh, axis)
    msgs = _on_devices(msg_pad, bands)
    return [
        _embed_block(band, msgs[band.device], tp.plane_id[k], tp.starts[k],
                     tp.lens[k], tp.moffs[k]) if band.numel() else band
        for k, band in enumerate(bands)
    ]


def extract_tiled_aligned(stego, tp: TileParams, mesh: Mesh,
                          axis: str = "tile") -> np.ndarray:
    """Per-shard aligned bit rows ``(n_shards, nwin, local_n)`` on the
    host (zero past each band's pixels)."""
    bands = split_rows(stego, mesh, axis)
    out = np.zeros((tp.n_shards, tp.nwin, tp.local_n), dtype=np.uint8)
    for k, band in enumerate(bands):
        if band.numel():
            rows = _extract_block(band, tp.plane_id[k], tp.starts[k],
                                  tp.lens[k]).cpu().numpy()
            out[k, :, :rows.shape[1]] = rows
    return out


# Copy of codec_tcc_tpu/parallel/tile.py::assemble_tiled (numpy only).
def assemble_tiled(aligned, tp: TileParams, out_len: int) -> np.ndarray:
    """Host back half of tiled extraction: place each shard window's bits at
    its message offset (disjoint ranges — plain memcpys)."""
    aligned = np.asarray(aligned)
    out = np.zeros(out_len, dtype=np.uint8)
    for k in range(tp.n_shards):
        for j in range(tp.nwin):
            ln = int(tp.lens[k, j])
            mo = int(tp.moffs[k, j])
            if ln <= 0 or mo >= out_len:
                continue
            ln = min(ln, out_len - mo)
            out[mo : mo + ln] = aligned[k, j, :ln]
    return out


def histogram_tiled(image, nbins: int, mesh: Mesh,
                    axis: str = "tile") -> np.ndarray:
    """Exact value histogram of a row-split image: one ``bincount`` per
    band on its device, summed on the host (the JAX package's ``psum``);
    the decomposition's only reduction."""
    counts = [hist_ops.value_histogram(band, nbins).cpu().numpy()
              for band in split_rows(image, mesh, axis) if band.numel()]
    return np.sum(counts, axis=0).astype(np.int32)


_MAX_KEYS = ("max_absdiff", "max_a", "max_b")


def pair_stats_tiled(a, b, mesh: Mesh, axis: str = "tile"):
    """Pair statistics over two row-split images (host images or bands):
    per-band float32 moments (:func:`..ops.metrics.pair_stats`), summed in
    float32 and maxed on the host as the JAX package's ``psum``/``pmax``
    combine them — feed to :func:`..ops.metrics.quality_report`."""
    per_band = [
        {k: v.cpu() for k, v in metric_ops.pair_stats(band_a, band_b).items()}
        for band_a, band_b in zip(split_rows(a, mesh, axis),
                                  split_rows(b, mesh, axis))
        if band_a.numel()
    ]
    stats = {}
    for key in per_band[0]:
        vals = torch.stack([st[key] for st in per_band])
        stats[key] = vals.amax() if key in _MAX_KEYS else vals.sum()
    return stats


# ---------------------------------------------------------------------------
# pipeline entry points (single large image across the mesh)
# ---------------------------------------------------------------------------


def encode_array_tiled(
    image: np.ndarray,
    payload: Union[bytes, str, np.ndarray],
    config: EncodeConfig = EncodeConfig(),
    mesh: Optional[Mesh] = None,
    axis: str = "tile",
    *,
    bits_stored: Optional[int] = None,
):
    """Tile-sharded counterpart of :func:`codec_tcc_tpu_torch.pipeline.
    encode_array` (strategies ``multi_plane`` / ``hybrid`` /
    ``block_adaptive``) producing a bit-identical container: same plan
    math, same container bytes — only the embed runs per band. Any
    geometry tiles over any mesh."""
    from ..pipeline import (
        EncodeResult, _as_payload_bits, _block_bases, _host_xor_maps,
        _plane_bucket,
    )
    from ..ops import blocks as block_ops

    config = config.validate()
    if config.strategy not in ("multi_plane", "hybrid", "block_adaptive"):
        raise ValueError(
            f"tiled encoding supports multi_plane/hybrid/block_adaptive, "
            f"not {config.strategy}"
        )
    if mesh is None:
        raise ValueError("encode_array_tiled requires a mesh with a tile axis")
    image = np.asarray(image)
    h, w = image.shape
    n = h * w
    n_shards = mesh.shape[axis]
    dtype_bits = image.dtype.itemsize * 8

    nbits = config.nbits
    if nbits is None:
        nbits = bits_stored if (config.use_bits_stored and bits_stored) else dtype_bits
    nbits = min(nbits, dtype_bits)

    msg_bits = _as_payload_bits(payload)
    total_bits = int(msg_bits.size)

    # the bands, uploaded once; the decomposition sums their histograms
    bands = split_rows(image, mesh, axis)
    max_val = 255 if image.dtype.itemsize == 1 else 65535
    counts = histogram_tiled(bands, max_val + 1, mesh, axis)
    dec = decompose_ops.decompose(
        image, beta=config.beta, nbits=nbits, histogram_counts=counts
    )
    s = dec.s

    plan = segment_ops.distribute_segments(s, total_bits, config.seed)
    dropped = total_bits - sum(min(e, n) for e in plan.eff_lengths)
    if dropped > 0 and not config.allow_capacity_overflow:
        raise ValueError(
            f"payload of {total_bits} bits exceeds the usable capacity at s={s}"
        )

    kernel_bits = _plane_bucket(s, dtype_bits)
    # the whole image on the axis' first device for the plan-time scans
    # (the hybrid start search, the block bases), as the JAX package runs
    # them on the unsharded image
    plan_dev = mesh.axis_devices(axis)[0]
    if config.strategy == "hybrid":
        counts0 = block_ops.block_bit_counts(
            torch.from_numpy(image).to(plan_dev), 0, config.search_block_size
        ).cpu().numpy()
        start = block_ops.best_offset_from_counts(
            counts0, h, w, config.search_block_size
        )
        pp = segment_ops.raster_plane_plan(
            plan, n, kernel_bits, start, config.align_across_planes
        )
    else:
        pp = segment_ops.raster_plane_plan(plan, n, kernel_bits, 0, True)

    if config.strategy == "block_adaptive":
        # variance-ranked placement: bases from one popcount pass over the
        # whole image (plan-time work, as the hybrid start search above),
        # then the per-band rank-compare embed
        bases = _block_bases(
            torch.from_numpy(image).to(plan_dev), kernel_bits, s,
            config.block_size, h, w,
        )
        msg_pad = embed_ops.pad_message(
            msg_bits, n, int(pp.offsets.max(initial=0))
        )
        msgs = _on_devices(msg_pad, bands)
        lh = shard_rows(h, n_shards)
        stego_bands = [
            _block_embed_band(band, msgs[band.device], bases, pp.lengths,
                              pp.offsets, s, k * lh, kernel_bits,
                              config.block_size) if band.numel() else band
            for k, band in enumerate(bands)
        ]
    else:
        tp = shard_windows(pp, n, n_shards, shard_rows(h, n_shards) * w)
        msg_pad = embed_ops.pad_message(
            msg_bits, tp.local_n, int(tp.moffs.max(initial=0))
        )
        stego_bands = embed_tiled(bands, msg_pad, tp, mesh, axis)

    metrics = None
    if config.compute_metrics:
        stats = pair_stats_tiled(bands, stego_bands, mesh, axis)
        metrics = metric_ops.quality_report(stats)
    stego = join_rows(stego_bands)

    maps = _host_xor_maps(image, stego, s)
    stego_blob = get_codec(config.codec).encode(stego)
    bitmaps_packed = config.store_bitmaps and n % 8 == 0
    if not config.store_bitmaps:
        bitmaps_blob = b""
    elif bitmaps_packed:
        bitmaps_blob = container_io.compress_bitmaps_packed(maps)
    else:
        bitmaps_blob = container_io.compress_bitmaps(maps)
    meta = container_io.ContainerMeta(
        version=2,
        codec=config.codec,
        strategy=config.strategy,
        s=s,
        nbits=nbits,
        bits_stored=bits_stored or nbits,
        dtype=image.dtype,
        width=w,
        height=h,
        start_offset=pp.base_start_offset,
        seed=config.seed,
        payload_bits=total_bits,
        align_across_planes=pp.align_across_planes,
        has_bitmaps=config.store_bitmaps,
        bitmaps_packed=bitmaps_packed,
        sizes=plan.sizes,
        indices=plan.indices,
        eff_lengths=tuple(int(v) for v in pp.lengths[:s]),
        plane_starts=tuple(int(v) for v in pp.starts[:s]),
        ext=(container_io.pack_block_ext(config.block_size)
             if config.strategy == "block_adaptive" else b""),
    )
    blob = container_io.pack(meta, bitmaps_blob, stego_blob)
    logger.info(
        "tiled encode: %dx%d over %d shards, s=%d, %d bits",
        h, w, n_shards, s, total_bits,
    )
    return EncodeResult(
        container=blob, stego=stego, meta=meta, decomposition=dec, metrics=metrics
    )


def decode_container_tiled(
    data: Union[bytes, container_io.Container],
    mesh: Mesh,
    axis: str = "tile",
    *,
    restore_original: bool = True,
):
    """Tile-sharded decode for raster-strategy containers: the stego image
    is row-split, each band extracts only its windows, assembly is host
    work."""
    from ..pipeline import DecodeResult, _plane_bucket, _plane_plan_from_meta

    cont = container_io.parse(data) if isinstance(data, (bytes, bytearray)) else data
    meta = cont.meta
    if meta.strategy not in ("multi_plane", "hybrid", "block_adaptive",
                             "unknown"):
        raise ValueError(f"tiled decode does not support {meta.strategy}")
    stego = get_codec(meta.codec).decode(cont.stego_blob)
    if meta.version == 1:
        meta.dtype = stego.dtype   # v1 records no dtype; trust the payload
    elif stego.dtype != meta.dtype:
        stego = stego.astype(meta.dtype)
    if stego.shape != (meta.height, meta.width):
        # same format-error contract as pipeline.decode_container and the
        # batch group decoder: a tampered/corrupt blob must not surface as
        # a raw numpy broadcast error (or silently truncated payload bits)
        raise ValueError(
            f"Invalid file: decoded stego shape {stego.shape} != header "
            f"{(meta.height, meta.width)}"
        )
    h, w = meta.height, meta.width
    n = h * w
    kernel_bits = _plane_bucket(meta.s, stego.dtype.itemsize * 8)
    starts, lengths, offsets = _plane_plan_from_meta(meta, n, kernel_bits)

    if meta.strategy == "block_adaptive":
        return _decode_block_tiled(
            cont, stego, lengths, offsets, kernel_bits, mesh, axis,
            restore_original,
        )
    pp = segment_ops.PlanePlan(
        nbits=kernel_bits, s=meta.s, total_bits=meta.payload_bits,
        starts=starts, lengths=lengths, offsets=offsets,
        base_start_offset=meta.start_offset,
        align_across_planes=meta.align_across_planes,
        segment=None,  # type: ignore[arg-type]
    )
    n_shards = mesh.shape[axis]
    tp = shard_windows(pp, n, n_shards, shard_rows(h, n_shards) * w)
    aligned = extract_tiled_aligned(stego, tp, mesh, axis)
    bits = assemble_tiled(aligned, tp, max(int(meta.payload_bits), 1))[
        : meta.payload_bits
    ]

    original = None
    if restore_original and meta.has_bitmaps:
        diff = cont.diff(stego.dtype)
        if diff is not None:
            original = stego ^ diff
    return DecodeResult(bits, stego, meta, original)


def _decode_block_tiled(
    cont, stego: np.ndarray, lengths: np.ndarray, offsets: np.ndarray,
    kernel_bits: int, mesh: Mesh, axis: str, restore_original: bool,
):
    """Tiled decode of a block_adaptive container: each band returns its
    raw plane bits, and the host places them at message positions via the
    rank permutation — ranks are a pure function of the restored
    original's tile bases, so nothing but plane bits leaves the devices."""
    from ..pipeline import DecodeResult, _block_bases

    meta = cont.meta
    h, w = meta.height, meta.width
    n = h * w
    diff = cont.diff(stego.dtype)
    if diff is None:
        raise ValueError(
            "block_adaptive extraction requires the XOR location maps"
        )
    original = stego ^ diff
    block = container_io.parse_block_ext(meta.ext)

    # bases from the restored original — the SAME helper the encoder and
    # single-image decoder use, so the ranking can never drift
    bases = _block_bases(
        torch.from_numpy(original).to(mesh.axis_devices(axis)[0]),
        kernel_bits, meta.s, block, h, w,
    )

    # full-band windows: plane p over each band's whole range, in band
    # order, so the raw plane bits of the image come back in raster order
    nplanes = min(meta.s, kernel_bits)  # only embedded planes leave a band
    plane_id = np.arange(nplanes, dtype=np.int32)
    zeros = np.zeros(nplanes, dtype=np.int32)
    planes = np.concatenate([
        _extract_block(band, plane_id, zeros,
                       np.full(nplanes, band.numel(), np.int32)).cpu().numpy()
        for band in split_rows(stego, mesh, axis) if band.numel()
    ], axis=1)  # (nplanes, n): raw plane bits, raster order

    out = np.zeros(max(int(meta.payload_bits), 1), dtype=np.uint8)
    tile_id, r = _host_block_geometry(h, w, block)
    order = np.empty(n, dtype=np.intp)
    for p in range(nplanes):
        ln = int(lengths[p])
        if ln <= 0:
            continue
        rank = bases[p][tile_id] + r
        # rank is a bijection onto 0..n-1, so its inverse is an O(n)
        # assignment, not an argsort (the tile layer exists for images
        # where n log n host sorts are seconds on the serving core)
        order[rank] = np.arange(n, dtype=np.intp)
        mo = int(offsets[p])
        take = min(ln, out.size - mo)
        if take > 0:
            out[mo : mo + take] = planes[p][order[:take]]
    bits = out[: meta.payload_bits]
    return DecodeResult(
        bits, stego, meta, original if restore_original else None
    )
