# Port of codec_tcc_tpu/parallel/volume.py on one device. The same code but
# for the device it passes: unpack_volume and extract_volume. Torch:
# volume_cut_point, _aggregate_volume_metrics, encode_volume,
# _encode_volume_pee (its capacity histograms are ops.pee.capacity_histogram
# over the slices, both parities, on the device), _xor_maps_batch and
# pack_volume. A `mesh` raises (ROADMAP.md, queue 1: multi-device).
"""Volume embed/extract: one payload across the slices of a volume.

BASELINE.json config[3] is a 64x512x512 uint16 volume. The semantics:

* one **global** cut point ``s`` for the whole volume, from the summed
  per-slice histograms;
* the payload is split across slices **capacity-aware** (contiguous chunks,
  each bounded by the slice's usable capacity), and every slice embeds its
  chunk with the standard per-slice segment plan at the shared ``s``: one
  K1 launch for the volume (:func:`.batch.encode_batch`), one K2 launch to
  read it back (:func:`extract_volume`);
* strategy ``pee`` splits by the slices' PEE capacity histograms and runs
  the batch PEE encoder (K3), each slice with its own threshold;
* the quality report aggregates one batched moments pass.

:func:`pack_volume` writes an STGV file: a volume header plus one
self-contained STGC-v2 container per slice, byte-identical to the JAX
package's. :func:`unpack_volume` decodes it through
:func:`.batch.decode_batch_containers` (raster slices on the host, PEE
slices through K4).

Every entry point takes ``device`` (default ``"cuda"``); the CPU runs the
kernels' plain versions, and only when a caller passes ``"cpu"``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..config import EncodeConfig
from ..device import to_device
from ..errors import CapacityError
from ..io import container as container_io
from ..ops import decompose as decompose_ops
from ..ops import metrics as metric_ops
from ..profiling import stage
from ..utils import bits as bit_utils
from . import batch as batch_par
from .batch_pee import _resolve

__all__ = [
    "VolumeResult", "encode_volume", "extract_volume", "volume_cut_point",
    "pack_volume", "unpack_volume",
]


@dataclass
class VolumeResult:
    stego: np.ndarray
    s: int                       # global cut point (0 for PEE volumes)
    plan: Optional[batch_par.BatchPlan]
    slice_bits: np.ndarray       # (D,) payload bits per slice
    metrics: Optional[dict] = None
    containers: Optional[list] = None   # per-slice STGC blobs (PEE volumes)
    threshold: Optional[int] = None     # shared PEE threshold


def volume_cut_point(
    volume, beta: float, mesh=None, *, device="cuda"
) -> Tuple[int, np.ndarray]:
    """Global cut point from the sum of the per-slice histograms (one
    ``bincount`` per slice on ``device``; a tensor volume stays on its
    device), then the exact float64 replay."""
    dev = _resolve(device, mesh)
    d, h, w = volume.shape
    itemsize = (volume.element_size() if isinstance(volume, torch.Tensor)
                else np.dtype(volume.dtype).itemsize)
    nbits = itemsize * 8
    max_val = 255 if itemsize == 1 else 65535
    with stage("volume_cut_point"):
        vol = volume if isinstance(volume, torch.Tensor) else to_device(
            volume, dev)
        total = batch_par.batched_histograms(vol, max_val + 1).sum(axis=0)
        # decompose reads only the dtype and size once the histogram is
        # given: a zero-alloc host proxy stands in for the volume
        proxy = np.broadcast_to(
            np.zeros((), np.uint8 if itemsize == 1 else np.uint16),
            (d * h, w))
        dec = decompose_ops.decompose(
            proxy, beta=beta, nbits=nbits, histogram_counts=total
        )
    return dec.s, total


def _aggregate_volume_metrics(volume, stego, dev: torch.device) -> dict:
    """One batched moments pass on ``dev``, summed (maxed for the max_*
    keys) across slices: the volume-wide quality report. The float32 sums
    run in another order than the JAX package's, as in
    :func:`.batch._batch_quality_reports`."""
    stats = metric_ops.pair_stats(to_device(volume, dev),
                                  to_device(stego, dev))
    agg = {k: float(torch.sum(v)) for k, v in stats.items()
           if k not in ("max_absdiff", "max_a", "max_b")}
    for k in ("max_absdiff", "max_a", "max_b"):
        agg[k] = float(torch.max(stats[k]))
    return metric_ops.quality_report(agg)  # type: ignore[arg-type]


def encode_volume(
    volume: np.ndarray,
    payload: Union[bytes, str, np.ndarray],
    config: EncodeConfig = EncodeConfig(),
    mesh=None,
    *,
    device="cuda",
) -> VolumeResult:
    dev = _resolve(device, mesh)
    d, h, w = volume.shape
    n = h * w
    if isinstance(payload, str):
        bits = bit_utils.message_to_bits(payload)
    elif isinstance(payload, (bytes, bytearray)):
        bits = bit_utils.bytes_to_bits(bytes(payload))
    else:
        bits = np.asarray(payload, dtype=np.uint8)
    total = int(bits.size)

    if config.strategy == "pee":
        return _encode_volume_pee(volume, bits, config, dev)
    if config.strategy not in ("multi_plane", "hybrid", "block_adaptive"):
        # an unimplemented strategy must raise, not silently get other
        # semantics
        raise ValueError(
            f"encode_volume implements strategies 'multi_plane', 'hybrid', "
            f"'block_adaptive' and 'pee', not '{config.strategy}'"
        )

    # one upload feeds the histograms, the block scans, the embed and the
    # metric moments
    vol_dev = to_device(volume, dev)
    s, hist_total = volume_cut_point(vol_dev, config.beta, device=dev)

    # capacity-aware contiguous split: the per-slice segment distribution
    # oversubscribes its lowest plane (quadratic weights), so the usable
    # per-slice chunk is bounded by the distribution's own clamp boundary
    from ..ops.segments import distribute_segments, usable_capacity_bits

    chunk_cap = usable_capacity_bits(s, n, config.seed)
    if chunk_cap * d < total:
        raise CapacityError(
            f"payload of {total} bits exceeds volume capacity {chunk_cap * d}"
        )

    slice_bits = np.zeros(d, dtype=np.int64)
    remaining = total
    for i in range(d):
        slice_bits[i] = min(remaining, chunk_cap)
        remaining -= slice_bits[i]

    payloads = []
    off = 0
    for i in range(d):
        payloads.append(bits[off : off + int(slice_bits[i])])
        off += int(slice_bits[i])

    # the global s for every slice: plan_batch recomputes per-image s, so
    # the per-slice plans are built here at the shared s
    from ..ops.segments import raster_plane_plan
    from ..pipeline import _plane_bucket

    if config.strategy == "hybrid":
        # per-slice variance-chosen start offsets: the same helper
        # plan_batch uses, so volumes and batches share the offset rule
        base_offsets = batch_par.hybrid_base_offsets(
            vol_dev, h, w, config.search_block_size
        )
        align = config.align_across_planes
    else:
        base_offsets = [0] * d
        align = True

    with stage("volume_plan"):
        nbits = _plane_bucket(s, np.dtype(volume.dtype).itemsize * 8)
        starts = np.zeros((d, nbits), dtype=np.int32)
        lengths = np.zeros((d, nbits), dtype=np.int32)
        offsets = np.zeros((d, nbits), dtype=np.int32)
        max_need = n
        for i in range(d):
            plan_i = distribute_segments(s, int(slice_bits[i]), config.seed)
            pp = raster_plane_plan(plan_i, n, nbits, base_offsets[i], align)
            starts[i], lengths[i], offsets[i] = (pp.starts, pp.lengths,
                                                 pp.offsets)
            max_need = max(max_need, int(pp.offsets.max(initial=0)) + n)
        lpad = 1 << max(3, (max_need - 1).bit_length())
        msgs = np.zeros((d, lpad), dtype=np.uint8)
        for i in range(d):
            msgs[i, : int(slice_bits[i])] = payloads[i]

    plan = batch_par.BatchPlan(
        s=np.full(d, s, dtype=np.int32),
        starts=starts, lengths=lengths, offsets=offsets,
        msgs=msgs, payload_bits=slice_bits, nbits=nbits, lpad=lpad,
        base_offsets=np.asarray(base_offsets, dtype=np.int64), align=align,
        seed=config.seed,
    )
    with stage("volume_embed"):
        if config.strategy == "block_adaptive":
            # variance-ranked tile placement per slice at the GLOBAL cut
            # point: the block batch's popcounts, ranking and embed
            bases = batch_par._batch_block_bases(
                vol_dev, nbits, plan.s, config.block_size, h, w
            )
            stego = batch_par._block_embed_batch(
                vol_dev, to_device(batch_par._msg_prefix(plan), dev),
                bases, lengths, offsets, plan.s, nbits, config.block_size,
            )
        else:
            # K1: every slice in one launch
            stego = batch_par.encode_batch(vol_dev, plan, device=dev)
    with stage("volume_download"):
        stego_np = stego.cpu().numpy()

    metrics = None
    if config.compute_metrics:
        with stage("volume_metrics"):
            metrics = _aggregate_volume_metrics(vol_dev, stego, dev)

    return VolumeResult(
        stego=stego_np, s=s, plan=plan, slice_bits=slice_bits, metrics=metrics
    )


def _cap_hists(vol: torch.Tensor, t_max: int, max_val: int):
    """Both parities' per-slice PEE capacity histograms, ``(D, 2*t_max)``
    each, on the volume's device."""
    from ..ops import pee as pee_ops

    return tuple(pee_ops.capacity_histogram(vol, parity, t_max, max_val)
                 for parity in (0, 1))


def _encode_volume_pee(
    volume: np.ndarray,
    bits: np.ndarray,
    config: EncodeConfig,
    dev: torch.device,
) -> VolumeResult:
    """PEE over a volume: histogram-driven capacity split across slices,
    per-slice thresholds.

    One device pass computes every slice's capacity histogram for both
    passes; the payload is split contiguously at the smallest uniform
    reference threshold whose (slightly discounted) estimated capacities
    cover it, and the batch encoder then gives each slice its own minimal
    T. Each slice's container is self-describing (T + used0/used1 in the
    PEE ext), so STGV decode is the standard per-slice path."""
    from ..models.pee import _MAX_T
    from ..ops import pee as pee_ops
    from .batch_pee import encode_pee_batch

    d, h, w = volume.shape
    total = int(bits.size)
    dtype_bits = np.dtype(volume.dtype).itemsize * 8
    max_val = (1 << dtype_bits) - 1

    vol_d = to_device(volume, dev)
    with stage("pee_histogram"):
        hist0, hist1 = _cap_hists(vol_d, _MAX_T, max_val)
        caps = (
            pee_ops.capacities_by_threshold(hist0.cpu().numpy()).astype(
                np.int64)
            + pee_ops.capacities_by_threshold(hist1.cpu().numpy()).astype(
                np.int64)
        )  # (d, _MAX_T): exact pass-0 + pristine pass-1 estimate per slice

    # The pass-1 half is an estimate (real pass 1 runs on the pass-0 stego);
    # discount the split so estimate error cannot overfill a slice. The
    # batch encoder's per-slice escalation absorbs anything that still
    # slips through; a second attempt with a harsher discount covers the
    # pathological case.
    def _try_split(caps_t: np.ndarray):
        """Contiguous split by per-slice capacities; None if they fall short
        of the payload, else (result, slice_bits) or None on CapacityError."""
        if int(caps_t.sum()) < total:
            return None
        sb = np.zeros(d, dtype=np.int64)
        remaining = total
        for i in range(d):
            sb[i] = min(remaining, int(caps_t[i]))
            remaining -= sb[i]
        chunks = []
        off = 0
        for i in range(d):
            chunks.append(bits[off : off + int(sb[i])])
            off += int(sb[i])
        try:
            return encode_pee_batch(volume, chunks, config, device=dev), sb
        except CapacityError:
            # only capacity exhaustion re-splits; other ValueErrors (bad
            # codec, malformed config) propagate
            return None

    r = None
    slice_bits = np.zeros(d, dtype=np.int64)
    for discount in (64, 1024):
        caps_d = np.maximum(caps - discount, 0)
        t_split = None
        for t in range(max(1, config.pee_threshold), _MAX_T + 1):
            if int(caps_d[:, t - 1].sum()) >= total:
                t_split = t
                break
        if t_split is None:
            continue
        got = _try_split(caps_d[:, t_split - 1])
        if got is not None:
            r, slice_bits = got
            break
    if r is None:
        # near-capacity payloads inside the estimate-error band: the EXACT
        # saturated probe (pass-1 capacity measured on the actual pass-0
        # stego) before giving up; the histogram split is the fast path,
        # not the capacity authority
        from .batch_pee import probe_capacity_batch

        for t in range(max(1, config.pee_threshold), _MAX_T + 1):
            est = int(caps[:, t - 1].sum())
            if est + 1024 * d < total:
                continue  # not worth probing: far below the payload
            exact = probe_capacity_batch(volume, t, max_val, device=dev)
            got = _try_split(np.asarray(exact))
            if got is not None:
                r, slice_bits = got
                break
    if r is None:
        raise CapacityError(
            f"payload of {total} bits exceeds the volume PEE capacity of "
            f"~{int(caps[:, -1].sum())} bits even at T={_MAX_T}"
        )

    metrics = None
    if config.compute_metrics:
        with stage("volume_metrics"):
            metrics = _aggregate_volume_metrics(vol_d, r.stego, dev)

    return VolumeResult(
        stego=r.stego, s=0, plan=None, slice_bits=slice_bits,
        metrics=metrics, containers=r.containers, threshold=r.threshold,
    )


VOLUME_MAGIC = b"STGV"


def _xor_maps_batch(volume: torch.Tensor, stego: torch.Tensor,
                    nbits: int) -> torch.Tensor:
    """``(D, nbits, H, W) uint8`` XOR location maps of the first ``nbits``
    planes of every slice, on the volume's device: the raw maps for
    geometries that do not bit-pack."""
    from ..ops.bitplanes import split_planes

    diff = volume.to(torch.int32) ^ stego.to(torch.int32)
    return torch.stack([split_planes(d, nbits) for d in diff])


def pack_volume(
    volume: np.ndarray,
    result: VolumeResult,
    config: EncodeConfig = EncodeConfig(),
    *,
    device="cuda",
) -> bytes:
    """Serialize a :class:`VolumeResult` as an STGV file: a volume header plus
    one self-contained STGC-v2 container per slice (so any slice decodes
    independently). The XOR maps come from ``device``."""
    import struct

    from ..io.codecs import get as get_codec
    from ..ops import embed as embed_ops
    from ..ops.segments import distribute_segments

    dev = _resolve(device, None)
    d, h, w = result.stego.shape
    s = result.s
    codec = get_codec(config.codec)
    total_bits = int(result.slice_bits.sum())

    strat_id = container_io.STRATEGY_IDS.get(config.strategy, 0)
    if result.containers is not None:
        # PEE volumes: the batch encoder already produced self-describing
        # per-slice containers
        blobs = list(result.containers)
        header = VOLUME_MAGIC + struct.pack(">IIQIB", 2, d, total_bits, s,
                                            container_io.STRATEGY_IDS["pee"])
        header += struct.pack(f">{d}Q", *[len(b) for b in blobs])
        return header + b"".join(blobs)

    with stage("volume_maps"):
        vol_dev = to_device(volume, dev)
        stego_dev = to_device(result.stego, dev)
        if (h * w) % 8 == 0:
            # the bit-packed s-plane maps: the container blobs' exact input
            maps_packed = embed_ops.xor_maps_packed_batch(
                vol_dev, stego_dev, s
            ).cpu().numpy()
            maps = None
        else:
            maps_packed = None
            maps = _xor_maps_batch(vol_dev, stego_dev, s).cpu().numpy()

    base_offsets = result.plan.base_offsets
    align = result.plan.align

    def pack_slice(i: int) -> bytes:
        plan_i = distribute_segments(s, int(result.slice_bits[i]), config.seed)
        meta = container_io.ContainerMeta(
            version=2,
            codec=config.codec,
            strategy=config.strategy,
            s=s,
            nbits=result.plan.nbits,
            bits_stored=result.plan.nbits,
            dtype=result.stego.dtype,
            width=w,
            height=h,
            start_offset=int(base_offsets[i]) if base_offsets is not None else 0,
            seed=config.seed,
            payload_bits=int(result.slice_bits[i]),
            align_across_planes=align,
            has_bitmaps=True,
            bitmaps_packed=(h * w) % 8 == 0,
            sizes=plan_i.sizes,
            indices=plan_i.indices,
            eff_lengths=tuple(int(v) for v in result.plan.lengths[i][:s]),
            plane_starts=tuple(int(v) for v in result.plan.starts[i][:s]),
            ext=(container_io.pack_block_ext(config.block_size)
                 if config.strategy == "block_adaptive" else b""),
        )
        blob = (
            container_io.compress_bitmaps_packed(maps_packed[i])
            if meta.bitmaps_packed
            else container_io.compress_bitmaps(maps[i][:s])
        )
        return container_io.pack(meta, blob, codec.encode(result.stego[i]))

    # per-slice compression in threads: zlib releases the GIL, so slices
    # compress in parallel on host cores
    from concurrent.futures import ThreadPoolExecutor

    from ..utils.pool import host_workers

    with stage("volume_pack"):
        with ThreadPoolExecutor(max_workers=host_workers(d)) as pool:
            blobs = list(pool.map(pack_slice, range(d)))

    header = VOLUME_MAGIC + struct.pack(">IIQIB", 2, d, total_bits, s, strat_id)
    header += struct.pack(f">{d}Q", *[len(b) for b in blobs])
    return header + b"".join(blobs)


def unpack_volume(data: bytes, *, device="cuda"):
    """Inverse of :func:`pack_volume`. Returns
    ``(payload_bits, stego_volume, original_volume)``."""
    import struct

    if data[:4] != VOLUME_MAGIC:
        raise ValueError("Invalid file: bad STGV signature")
    try:
        version, d, total_bits, s = struct.unpack_from(">IIQI", data, 4)
        off = 4 + struct.calcsize(">IIQI")
        if version >= 2:  # v2 records the volume-level strategy
            (strat_id,) = struct.unpack_from(">B", data, off)
            off += 1
            if strat_id not in container_io.STRATEGY_NAMES:
                raise ValueError(
                    f"Invalid file: unknown STGV strategy id {strat_id}"
                )
        sizes = struct.unpack_from(f">{d}Q", data, off)
    except struct.error as exc:
        raise ValueError(f"Invalid file: truncated STGV header ({exc})") from exc
    off += 8 * d
    if off + sum(sizes) > len(data):
        raise ValueError(
            f"Invalid file: STGV body truncated (need {off + sum(sizes)} "
            f"bytes, have {len(data)})"
        )

    blobs = []
    for i in range(d):
        blobs.append(data[off : off + sizes[i]])
        off += sizes[i]
    # homogeneous slices (the normal case) decode as one group: raster
    # slices on the host, PEE slices through K4; mixed or odd volumes go
    # per slice inside decode_batch_containers
    from .batch import decode_batch_containers

    decs = decode_batch_containers(blobs, device=device)
    bits_parts = [dec.payload_bits for dec in decs]
    stego_slices = [dec.stego for dec in decs]
    orig_slices = [dec.original for dec in decs]
    payload = np.concatenate(bits_parts)[:total_bits] if bits_parts else np.zeros(0, np.uint8)
    stego = np.stack(stego_slices)
    original = np.stack(orig_slices) if all(o is not None for o in orig_slices) else None
    return payload, stego, original


def extract_volume(
    stego: np.ndarray, result_plan: batch_par.BatchPlan, mesh=None, *,
    device="cuda",
) -> np.ndarray:
    """Recover the full payload bit array from a stego volume: one K2
    launch for every slice."""
    bits = np.asarray(batch_par.extract_batch(stego, result_plan, mesh,
                                              device=device))
    out = []
    for i in range(stego.shape[0]):
        out.append(bits[i, : int(result_plan.payload_bits[i])])
    return np.concatenate(out) if out else np.zeros(0, dtype=np.uint8)
