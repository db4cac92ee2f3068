# Port of codec_tcc_tpu/parallel/tile_pee.py on a mesh of torch devices,
# through the band mode of K3/K4 (the JAX package's Pallas route; its XLA
# route is the plain band versions in ops/pee.py, which the kernel wrappers
# run for CPU tensors). `backend`, `interpret` and `pallas_supported` are
# TPU routing and are gone; any geometry tiles over any mesh, the last
# bands shorter or empty instead of zero-padded.
"""Tile-sharded PEE: one large image's rows split across the mesh.

The PEE counterpart of :mod:`.tile`. Band ``k`` of the image (rows
``[k*lh, (k+1)*lh)`` on the ``k``-th device of the mesh axis) runs each
pass through K3/K4 in band mode: per band, K3's count launch and its apply
launch, K4's count launch and its apply launch. What couples the bands
reduces to three small exchanges per pass:

* **halo rows** — the rhombus prediction of a band's first and last rows
  needs one row from each neighbour band: a copy of a ``(W,)`` row between
  devices (the image's border bands pass their own edge row, matching
  :func:`..ops.pee.rhombus_predict`'s edge replication);
* **rank prefix** — the bit-to-pixel mapping is the global raster rank
  among eligible pixels: each band's per-tile eligible counts
  (:func:`..ops.pee_kernels.pee_count_band`) gather on the first device,
  one ``cumsum`` gives each band the count of the bands above it, and its
  apply launch ranks its tiles from there;
* **processed boundary** — the used-th eligible pixel lies in one band;
  the pass's boundary is the largest set rank the bands process, a max of
  ``K`` scalars, downloaded with the image's eligible count in one copy.

The pass's message base and budget, and the inverse pass's boundary, go
to every launch by value. An inverse pass downloads every band's bits and
count in one copy.

Pixels never move between bands. Containers are byte-identical to the
single-device PEE encoder's (:func:`..models.pee.encode_pee_array`).

The stego is joined on the first band's device and takes the
single-image routes' transport, which picks the codec from that device:
on a CUDA device the encode deflates it on the card
(:func:`..ops.deflate_rle.transport_encode`) while the host compresses
the overflow map, packed on the same device, and the decode inflates it
there (:func:`..ops.inflate.transport_decode`) and splits the bands from
the device image; on the CPU both go to the host codec. The decode's
overflow map goes up packed and expands on that device
(:func:`..models.pee.overflow_map_on`) before its bands split.

Spans and counters (:mod:`..profiling`): the entry points' own spans; the
single PEE route's stages where the same work runs (``image_upload``,
``pee_histogram``, ``embed``, ``transport_codec``, ``transport_decode``,
``extract``, ``restore``); ``band_pass`` around each pass over the bands,
inside ``embed`` or ``extract``; the counters ``tile.band_passes`` (those
passes), ``tile.bands`` (live bands launched, summed over the passes) and
``tile.attempts`` (the encode's T attempts), and the decode's
``pee.map_device`` or ``pee.map_host``.
"""

from __future__ import annotations

import functools
import zlib
from typing import Optional, Union

import numpy as np
import torch

from ..config import EncodeConfig
from ..device import download
from ..io import container as container_io
from ..io.codecs import get as get_codec
from ..ops import deflate_rle
from ..ops import embed as embed_ops
from ..ops import inflate
from ..ops import metrics as metric_ops
from ..ops import pee as pee_ops
from ..ops import pee_kernels
from ..profiling import count, entry, stage
from ..utils.logging import get_logger
from .mesh import Mesh, device_guard
from .tile import Bands, _on_devices, shard_rows, split_rows

logger = get_logger("parallel.tile_pee")

__all__ = [
    "embed_pass_tiled",
    "extract_pass_tiled",
    "encode_array_tiled_pee",
    "decode_container_tiled_pee",
]


def _halo_rows(bands: Bands, k: int):
    """(top, bottom) ``(1, W)`` rows of band ``k`` on its device: the
    neighbour bands' edge rows; the image's border bands replicate their
    own edge row (= the single-device ``mode="edge"`` padding)."""
    band = bands[k]
    up = bands[k - 1] if k > 0 else None
    down = bands[k + 1] if k + 1 < len(bands) else None
    top = up[-1:] if up is not None else band[:1]
    bot = down[:1] if down is not None and down.numel() else band[-1:]
    return top.to(band.device), bot.to(band.device)


def _live(bands: Bands):
    """``{k: first global row}`` of the non-empty bands (band k starts at
    row ``k * shard_rows(h, K)``)."""
    h = sum(band.shape[0] for band in bands)
    lh = shard_rows(h, len(bands))
    return {k: k * lh for k, band in enumerate(bands) if band.numel()}


def _gathered(bands: Bands) -> torch.Tensor:
    """A row-split image's bands joined on the first band's device."""
    first = bands[0].device
    return torch.cat([band.to(first) for band in bands])


def _band_pass(fn):
    """A pass over the bands: its ``band_pass`` span and one
    ``tile.band_passes``."""

    @functools.wraps(fn)
    def spanned(*args, **kwargs):
        count("tile.band_passes")
        with stage("band_pass"):
            return fn(*args, **kwargs)

    return spanned


@_band_pass
def embed_pass_tiled(
    image, msg_bits, msg_base: int, want: int, parity: int, t: int,
    max_val: int, mesh: Mesh, axis: str = "tile",
):
    """One PEE pass over a row-split image (a host image or its bands).
    Returns ``(stego_bands, overflow_bands u8, used, n_proc)``, the bands
    on their devices and ``used``/``n_proc`` as ints. ``msg_bits`` is the
    whole padded message (a host array, or its ``(1, L)`` copy per device
    from :func:`.tile._on_devices`)."""
    bands = split_rows(image, mesh, axis)
    h, w = sum(band.shape[0] for band in bands), bands[0].shape[1]
    row0 = _live(bands)
    msgs = msg_bits if isinstance(msg_bits, dict) else _on_devices(
        np.asarray(msg_bits)[None], bands)
    halos = {k: _halo_rows(bands, k) for k in row0}
    count("tile.bands", len(row0))

    # the rank prefix: every band's per-tile eligible counts, gathered on
    # the first device; band k's rank base is the sum of the rows above it
    counts = {}
    for k in row0:
        with device_guard(bands[k].device):
            counts[k] = pee_kernels.pee_count_band(
                bands[k][None], *halos[k], row0[k], h, parity, t, max_val)
    first = bands[0].device
    rows = [counts[k][0].to(first) for k in row0]
    csum = torch.cumsum(rows[0] if len(rows) == 1 else torch.cat(rows), 0,
                        dtype=torch.int32)

    stego = list(bands)
    over = [None if k in row0 else torch.zeros_like(band, dtype=torch.uint8)
            for k, band in enumerate(bands)]
    nprocs, end = [], 0
    for k, row in zip(row0, rows):
        dev = bands[k].device
        rank_base = csum[end - 1:end].to(dev) if end else None
        end += row.numel()
        with device_guard(dev):
            s_k, o_k, n_k = pee_kernels.pee_embed_band(
                bands[k][None], *halos[k], row0[k], h, counts[k], rank_base,
                msgs[dev], msg_base, want, parity, t, max_val)
        stego[k], over[k] = s_k[0], o_k[0]
        nprocs.append(n_k.to(first))
    # one download: the image's eligible count and each band's boundary
    cap, *band_nprocs = download(torch.cat([csum[-1:], *nprocs])).tolist()
    used = min(want, cap)
    n_proc = h * w if want > cap else (max(band_nprocs) if used > 0 else 0)
    return stego, over, used, n_proc


@_band_pass
def extract_pass_tiled(
    stego, overflow, n_proc: int, parity: int, t: int, out_len: int,
    mesh: Mesh, axis: str = "tile",
):
    """Invert one PEE pass over a row-split stego image (host images or
    bands). Returns ``(restored_bands, bits (out_len,), n_bits)``: each
    band's bits come back in band rank order, every band's with its count
    in one download, and are placed on the host at the count of the bands
    above it."""
    bands = split_rows(stego, mesh, axis)
    overs = split_rows(overflow, mesh, axis)
    h = sum(band.shape[0] for band in bands)
    first = bands[0].device
    restored = list(bands)
    nbits, rows = [], []
    live = _live(bands)
    count("tile.bands", len(live))
    for k, row0 in live.items():
        with device_guard(bands[k].device):
            r_k, bits_k, n_k = pee_kernels.pee_extract_band(
                bands[k][None], *_halo_rows(bands, k), row0, h,
                overs[k][None], n_proc, parity, t, out_len)
        restored[k] = r_k[0]
        nbits.append(n_k.to(first).view(torch.uint8))
        rows.append(bits_k[0].to(first))
    flat = download(torch.cat(nbits + rows))
    counts = flat[:4 * len(rows)].view(np.int32)
    out = np.zeros(out_len, dtype=np.uint8)
    off, pos = 0, 4 * len(rows)
    for c, row in zip(counts.tolist(), rows):
        take = min(c, out_len - off)
        if take > 0:
            out[off:off + take] = flat[pos:pos + take]
        off += c
        pos += row.numel()
    return restored, out, off


def _capacity_histogram_tiled(bands: Bands, parity: int, t_max: int,
                              max_val: int) -> np.ndarray:
    """:func:`..ops.pee.capacity_histogram` of the whole image, as the sum
    of its bands' histograms."""
    h = sum(band.shape[0] for band in bands)
    hist = [
        download(pee_ops.band_capacity_histogram(
            bands[k][None], *_halo_rows(bands, k),
            torch.full((1,), row0, dtype=torch.int32, device=bands[k].device),
            parity, t_max, max_val, h)[0])
        for k, row0 in _live(bands).items()
    ]
    return np.sum(hist, axis=0)


@entry
def encode_array_tiled_pee(
    image: np.ndarray,
    payload,
    config: EncodeConfig = EncodeConfig(),
    mesh: Optional[Mesh] = None,
    axis: str = "tile",
    *,
    bits_stored: Optional[int] = None,
):
    """Tile-sharded PEE encode of one large image — byte-identical container
    to :func:`codec_tcc_tpu_torch.models.pee.encode_pee_array` (same
    escalation protocol, same ext/overflow-map layout)."""
    from ..errors import CapacityError
    from ..models.pee import _MAX_T, max_value, select_threshold
    from ..ops.decompose import DecompositionResult
    from ..pipeline import EncodeResult, _as_payload_bits
    from .tile import pair_stats_tiled

    if mesh is None:
        raise ValueError("encode_array_tiled_pee requires a mesh")
    image = np.asarray(image)
    h, w = image.shape
    dtype_bits = image.dtype.itemsize * 8
    eff_bits = bits_stored if (config.use_bits_stored and bits_stored) else dtype_bits
    max_val = max_value(int(image.max()), dtype_bits, eff_bits)

    msg_bits = _as_payload_bits(payload)
    total_bits = int(msg_bits.size)
    lpad = 1 << max(3, (max(total_bits, 1) - 1).bit_length())
    msg_pad = np.zeros(lpad, dtype=np.uint8)
    msg_pad[:total_bits] = msg_bits

    with stage("image_upload"):
        img0 = split_rows(image, mesh, axis)
        msgs = _on_devices(msg_pad[None], img0)

    # histogram-driven threshold selection — identical rule to
    # models.pee.encode_pee_array, so the container stays byte-identical to
    # the single-device encoder's; each band's histogram, summed
    with stage("pee_histogram"):
        cap0 = pee_ops.capacities_by_threshold(
            _capacity_histogram_tiled(img0, 0, _MAX_T, max_val))
        cap1 = pee_ops.capacities_by_threshold(
            _capacity_histogram_tiled(img0, 1, _MAX_T, max_val))
    t = select_threshold(cap0, cap1, total_bits, config.pee_threshold)
    if t is None:
        t = _MAX_T  # one exact attempt (the histogram only schedules)

    def run_pass(img, base, wnt, parity, t):
        return embed_pass_tiled(img, msgs, base, wnt, parity, t, max_val,
                                mesh, axis)

    result = None
    with stage("embed"):
        while t <= _MAX_T:
            count("tile.attempts")
            s0, o0, used0, n0 = run_pass(img0, 0, total_bits, 0, t)
            want1 = total_bits - used0
            if want1 <= 0:
                result = (t, s0, o0, used0, n0, None, 0, 0, 1)
                break
            # pass 1 runs on pass 0's stego bands, where they lie: the halo
            # rows come from pass 0's stego
            s1, o1, u1, n1 = run_pass(s0, used0, want1, 1, t)
            if u1 < want1:
                t += 1  # pass-interaction shortfall of the estimate; escalate
                continue
            result = (t, s1, o0, used0, n0, o1, u1, n1, 2)
            break
        if result is None:
            raise CapacityError(
                f"payload of {total_bits} bits exceeds PEE capacity even at "
                f"T={_MAX_T}"
            )
        t, stego_d, over0, used0, nproc0, over1, used1, nproc1, passes = result
        over = over0 if over1 is None else [a | b for a, b in zip(over0, over1)]
        stego_dev = _gathered(stego_d)
        stego_np = download(stego_dev)
        # the blob's zlib input: the h*w-bit map packed MSB-first on the
        # first band's device, as the single-device encoder's
        packed_over = download(
            embed_ops.pack_bits_batch(_gathered(over)[None])[0])
        metrics = None
        if config.compute_metrics:
            metrics = metric_ops.encode_report(
                pair_stats_tiled(img0, stego_d, mesh, axis), image, stego_np)

    with stage("transport_codec"):
        stego_bytes = deflate_rle.transport_encode(
            get_codec(config.codec), stego_np, stego_dev)
        map_blob = zlib.compress(packed_over.tobytes())
        stego_blob = stego_bytes()
    ext = container_io.pack_pee_ext(t, passes, nproc0, nproc1, used0, used1)
    meta = container_io.ContainerMeta(
        version=2, codec=config.codec, strategy="pee", s=0,
        nbits=eff_bits, bits_stored=eff_bits, dtype=image.dtype,
        width=w, height=h, start_offset=0, seed=config.seed,
        payload_bits=total_bits, align_across_planes=False,
        has_bitmaps=True, sizes=(), indices=(), eff_lengths=(),
        plane_starts=(), ext=ext,
    )
    blob = container_io.pack(meta, map_blob, stego_blob)
    logger.info(
        "tiled pee encode: %dx%d over %d shards, T=%d, %d bits",
        h, w, mesh.shape[axis], t, total_bits,
    )
    dec = DecompositionResult(
        s=0, nbits=eff_bits, entropy=0.0, target=0.0,
        mi=np.zeros(0), cumulative=np.zeros(0),
    )
    return EncodeResult(
        container=blob, stego=stego_np, meta=meta, decomposition=dec,
        metrics=metrics,
    )


@entry
def decode_container_tiled_pee(
    data: Union[bytes, container_io.Container],
    mesh: Mesh,
    axis: str = "tile",
    *,
    restore_original: bool = True,
):
    """Tile-sharded PEE decode: the stego rows stay on their band's device
    through both inverse passes; each band's bits land at the count of the
    bands above it."""
    from ..models.pee import overflow_map_on, parse_pee_container_packed
    from ..pipeline import DecodeResult

    cont = (
        container_io.parse(data) if isinstance(data, (bytes, bytearray))
        else data
    )
    meta = cont.meta
    if meta.strategy != "pee":
        raise ValueError(f"not a PEE container (strategy={meta.strategy})")
    (t, passes, nproc0, nproc1, bits0, bits1), raw = (
        parse_pee_container_packed(cont)
    )
    # inflated on the first band's device: on the card by the kernels, on
    # the CPU by the host codec
    first = mesh.axis_devices(axis)[0]
    with stage("transport_decode"):
        stego, stego_dev = inflate.transport_decode(
            get_codec(meta.codec), cont.stego_blob, first)
    if stego.dtype != meta.dtype:
        stego = stego.astype(meta.dtype)
        stego_dev = None
    h, w = meta.height, meta.width
    if stego.shape != (h, w):
        raise ValueError(
            f"Invalid file: decoded stego shape {stego.shape} != header "
            f"{(h, w)}")
    out_len = 1 << max(3, (max(int(meta.payload_bits), 1) - 1).bit_length())

    with stage("extract"):
        # split the stego (from its device image where the kernels
        # inflated it) and the overflow map, expanded on the first band's
        # device, once; the inter-pass image stays on the bands' devices
        img = split_rows(stego if stego_dev is None else stego_dev, mesh,
                         axis)
        over = split_rows(overflow_map_on(raw, h, w, first), mesh, axis)
        bits1_arr = np.zeros(0, dtype=np.uint8)
        if passes == 2:
            img, b1, n1 = extract_pass_tiled(img, over, nproc1, 1, t,
                                             out_len, mesh, axis)
            bits1_arr = b1[:n1]
        img, b0, n0 = extract_pass_tiled(img, over, nproc0, 0, t, out_len,
                                         mesh, axis)
        bits0_arr = b0[:n0]

    payload_bits = np.concatenate([bits0_arr, bits1_arr])[: meta.payload_bits]
    original = None
    if restore_original:
        with stage("restore"):
            original = download(_gathered(img))
    return DecodeResult(
        payload_bits=payload_bits.astype(np.uint8),
        stego=stego,
        meta=meta,
        original=original,
    )
