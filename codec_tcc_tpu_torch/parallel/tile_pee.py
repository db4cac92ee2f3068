# Port of codec_tcc_tpu/parallel/tile_pee.py on a mesh of torch devices,
# through the shard mode of K3/K4 (the JAX package's Pallas route; its XLA
# route is the plain band versions in ops/pee.py, which the kernel wrappers
# run for CPU tensors). `backend`, `interpret` and `pallas_supported` are
# TPU routing and are gone; any geometry tiles over any mesh, the last
# bands shorter or empty instead of zero-padded.
"""Tile-sharded PEE: one large image's rows split across the mesh.

The PEE counterpart of :mod:`.tile`. Band ``k`` of the image (rows
``[k*lh, (k+1)*lh)`` on the ``k``-th device of the mesh axis) runs each
pass through K3/K4 in shard mode, one launch per band. What couples the
bands reduces to three small exchanges per pass:

* **halo rows** — the rhombus prediction of a band's first and last rows
  needs one row from each neighbour band: a copy of a ``(W,)`` row between
  devices (the image's border bands pass their own edge row, matching
  :func:`..ops.pee.rhombus_predict`'s edge replication);
* **rank prefix** — the bit-to-pixel mapping is the global raster rank
  among eligible pixels: each band's eligible count (a torch-op sweep of
  the band, :func:`..ops.pee.band_eligible_count`) gathers on the first
  device, and each band's kernel starts its ranks at the exclusive prefix
  of the bands above it;
* **processed boundary** — the used-th eligible pixel lies in one band;
  the pass's boundary is the largest set rank the bands process, a max of
  ``K`` scalars.

Pixels never move between bands. Containers are byte-identical to the
single-device PEE encoder's (:func:`..models.pee.encode_pee_array`).
"""

from __future__ import annotations

import zlib
from typing import Optional, Union

import numpy as np
import torch

from ..config import EncodeConfig
from ..io import container as container_io
from ..io.codecs import get as get_codec
from ..ops import metrics as metric_ops
from ..ops import pee as pee_ops
from ..ops import pee_kernels
from ..utils.logging import get_logger
from .mesh import Mesh, device_guard
from .tile import Bands, _on_devices, join_rows, shard_rows, split_rows

logger = get_logger("parallel.tile_pee")

__all__ = [
    "embed_pass_tiled",
    "extract_pass_tiled",
    "encode_array_tiled_pee",
    "decode_container_tiled_pee",
]


def _scalar(v: int, dev: torch.device) -> torch.Tensor:
    return torch.tensor([int(v)], dtype=torch.int32, device=dev)


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


def _row0s(bands: Bands, h: int):
    """``{k: (1,) int32 first global row}`` of the non-empty bands, each on
    its band's device (band k starts at row ``k * shard_rows(h, K)``)."""
    lh = shard_rows(h, len(bands))
    return {k: _scalar(k * lh, band.device)
            for k, band in enumerate(bands) if band.numel()}


def embed_pass_tiled(
    image, msg_bits, msg_base: int, want: int, parity: int, t: int,
    max_val: int, mesh: Mesh, axis: str = "tile",
):
    """One PEE pass over a row-split image (a host image or its bands).
    Returns ``(stego_bands, overflow_bands u8, used, n_proc)``, the bands
    on their devices and ``used``/``n_proc`` as 0-d int32 tensors on the
    first band's device. ``msg_bits`` is the whole padded message (a host
    array, or its ``(1, L)`` copy per device from
    :func:`.tile._on_devices`)."""
    bands = split_rows(image, mesh, axis)
    h, w = sum(band.shape[0] for band in bands), bands[0].shape[1]
    row0 = _row0s(bands, h)
    msgs = msg_bits if isinstance(msg_bits, dict) else _on_devices(
        np.asarray(msg_bits)[None], bands)
    halos = {k: _halo_rows(bands, k) for k in row0}

    # the rank prefix: every band's eligible count, gathered on the first
    # device, its exclusive prefix sent back to each band
    first = bands[0].device
    counts = torch.cat([
        pee_ops.band_eligible_count(bands[k][None], *halos[k], row0[k],
                                    parity, t, max_val, h).to(first)
        for k in row0
    ])
    prefix = torch.cumsum(counts, 0, dtype=torch.int32) - counts
    total_cap = counts.sum(dtype=torch.int32)

    stego = list(bands)
    over = [torch.zeros_like(band, dtype=torch.uint8) for band in bands]
    nprocs = []
    for i, k in enumerate(row0):
        dev = bands[k].device
        with device_guard(dev):
            s_k, o_k, _, n_k = pee_kernels.pee_embed(
                bands[k][None], msgs[dev], _scalar(msg_base, dev),
                _scalar(want, dev), parity, t, max_val,
                shard=(*halos[k], row0[k], prefix[i:i + 1].to(dev), h),
            )
        stego[k], over[k] = s_k[0], o_k[0]
        nprocs.append(n_k.to(first))
    wnt = torch.tensor(int(want), dtype=torch.int32, device=first)
    used = torch.minimum(wnt, total_cap)
    n_proc = torch.where(
        wnt > total_cap, h * w,
        torch.where(used > 0, torch.cat(nprocs).amax(), 0),
    ).to(torch.int32)
    return stego, over, used, n_proc


def extract_pass_tiled(
    stego, overflow, n_proc: int, parity: int, t: int, out_len: int,
    mesh: Mesh, axis: str = "tile",
):
    """Invert one PEE pass over a row-split stego image (host images or
    bands). Returns ``(restored_bands, bits (out_len,), n_bits)``: each
    band's bits come back in band rank order and are placed on the host at
    the count of the bands above it."""
    bands = split_rows(stego, mesh, axis)
    overs = split_rows(overflow, mesh, axis)
    h = sum(band.shape[0] for band in bands)
    restored = list(bands)
    runs = []
    for k, row0 in _row0s(bands, h).items():
        with device_guard(row0.device):
            r_k, bits_k, n_k = pee_kernels.pee_extract(
                bands[k][None], overs[k][None], _scalar(n_proc, row0.device),
                parity, t, out_len, shard=(*_halo_rows(bands, k), row0, h),
            )
        restored[k] = r_k[0]
        runs.append((bits_k[0], n_k))
    out = np.zeros(out_len, dtype=np.uint8)
    off = 0
    for bits_k, n_k in runs:
        c = int(n_k)
        take = min(c, out_len - off)
        if take > 0:
            out[off:off + take] = bits_k[:take].cpu().numpy()
        off += c
    return restored, out, off


def _capacity_histogram_tiled(bands: Bands, parity: int, t_max: int,
                              max_val: int) -> np.ndarray:
    """:func:`..ops.pee.capacity_histogram` of the whole image, as the sum
    of its bands' histograms."""
    h = sum(band.shape[0] for band in bands)
    hist = [
        pee_ops.band_capacity_histogram(
            bands[k][None], *_halo_rows(bands, k), row0, parity, t_max,
            max_val, h)[0].cpu().numpy()
        for k, row0 in _row0s(bands, h).items()
    ]
    return np.sum(hist, axis=0)


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

    img0 = split_rows(image, mesh, axis)
    msgs = _on_devices(msg_pad[None], img0)

    # histogram-driven threshold selection — identical rule to
    # models.pee.encode_pee_array, so the container stays byte-identical to
    # the single-device encoder's; each band's histogram, summed
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
    while t <= _MAX_T:
        s0, o0, u0, n0 = run_pass(img0, 0, total_bits, 0, t)
        used0 = int(u0)
        want1 = total_bits - used0
        if want1 <= 0:
            result = (t, s0, o0, used0, int(n0), None, 0, 0, 1)
            break
        # pass 1 runs on pass 0's stego bands, where they lie: the halo
        # rows come from pass 0's stego
        s1, o1, u1, n1 = run_pass(s0, used0, want1, 1, t)
        if int(u1) < want1:
            t += 1  # pass-interaction shortfall of the estimate; escalate
            continue
        result = (t, s1, o0, used0, int(n0), o1, int(u1), int(n1), 2)
        break
    if result is None:
        raise CapacityError(
            f"payload of {total_bits} bits exceeds PEE capacity even at "
            f"T={_MAX_T}"
        )
    t, stego_d, over0, used0, nproc0, over1, used1, nproc1, passes = result
    stego_np = join_rows(stego_d)
    over = over0 if over1 is None else [a | b for a, b in zip(over0, over1)]
    # the blob's zlib input: the h*w-bit map packed MSB-first, as the
    # single-device encoder's
    map_blob = zlib.compress(np.packbits(join_rows(over).reshape(-1)).tobytes())

    metrics = None
    if config.compute_metrics:
        metrics = metric_ops.quality_report(
            pair_stats_tiled(img0, stego_d, mesh, axis)
        )

    stego_blob = get_codec(config.codec).encode(stego_np)
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
    from ..models.pee import parse_pee_container_parts
    from ..pipeline import DecodeResult

    cont = (
        container_io.parse(data) if isinstance(data, (bytes, bytearray))
        else data
    )
    meta = cont.meta
    if meta.strategy != "pee":
        raise ValueError(f"not a PEE container (strategy={meta.strategy})")
    (t, passes, nproc0, nproc1, bits0, bits1), overflow = (
        parse_pee_container_parts(cont)
    )
    stego = get_codec(meta.codec).decode(cont.stego_blob)
    if stego.dtype != meta.dtype:
        stego = stego.astype(meta.dtype)
    h, w = meta.height, meta.width
    if stego.shape != (h, w):
        raise ValueError(
            f"Invalid file: decoded stego shape {stego.shape} != header "
            f"{(h, w)}")
    out_len = 1 << max(3, (max(int(meta.payload_bits), 1) - 1).bit_length())

    # split the stego and the overflow map once; the inter-pass image stays
    # on the bands' devices
    img = split_rows(stego, mesh, axis)
    over = split_rows(np.asarray(overflow, dtype=np.uint8), mesh, axis)
    bits1_arr = np.zeros(0, dtype=np.uint8)
    if passes == 2:
        img, b1, n1 = extract_pass_tiled(img, over, nproc1, 1, t, out_len,
                                         mesh, axis)
        bits1_arr = b1[:n1]
    img, b0, n0 = extract_pass_tiled(img, over, nproc0, 0, t, out_len,
                                     mesh, axis)
    bits0_arr = b0[:n0]

    payload_bits = np.concatenate([bits0_arr, bits1_arr])[: meta.payload_bits]
    original = join_rows(img) if restore_original else None
    return DecodeResult(
        payload_bits=payload_bits.astype(np.uint8),
        stego=stego,
        meta=meta,
        original=original,
    )
