# Port of codec_tcc_tpu/pipeline.py (encode/decode of the raster and block
# strategies, the host embed route, capacity planning and analyze).
# load_input is the same code; analyze_pair the same code but for the
# device it passes; capacity_report runs its histograms and PEE probe on
# the device.
"""End-to-end encode / decode pipelines (host orchestration shell).

The raster path of the JAX package, in torch: the image is uploaded once;
the value histogram, the hybrid block scan, the raster embed (kernel K1,
which also emits the bit-packed XOR maps) and the metric moments run on the
device; the float64 cut-point replay, the segment plan, the deflate codec
and the STGC container stay host code. Decode inflates the stego on the
host, uploads it, extracts the payload bits with kernel K2 and restores the
original from the container's maps on the host.

Strategy ``block_adaptive`` encodes on the device in torch ops (tile
popcounts, the variance-ranked embed, the packed maps) and decodes on the
host (:mod:`.ops.host_extract`), as the JAX package does. The host embed
route (``device_policy="host"``, or ``"auto"`` with
``compute_metrics=False``; ``EncodeConfig.resolve_host_route``) places a
raster payload with numpy windows (:mod:`.ops.host_embed`) and never
uploads the image. Strategy ``pee`` dispatches early to
:mod:`.models.pee` (kernels K3/K4).

Containers are byte-identical to the JAX package's for the strategies,
codecs and container versions ported so far (``hybrid``, ``multi_plane``,
``block_adaptive`` and ``pee``; ``deflate``; STGC v2/v2.1). Everything else
raises ``NotImplementedError`` naming its ROADMAP.md item.

Every entry point takes ``device`` (default ``"cuda"``). The CPU runs the
kernels' plain torch versions, and only when a caller passes ``"cpu"``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from .config import EncodeConfig
from .device import DeviceLike, resolve_device, upload
from .errors import CapacityError
from .io import container as container_io
from .io import dicom
from .io.codecs import get as get_codec
from .io.codecs import names as codec_names
from .ops import blocks as block_ops
from .ops import decompose as decompose_ops
from .ops import embed as embed_ops
from .ops import host_extract
from .ops import metrics as metric_ops
from .ops import raster_kernels
from .ops import segments as segment_ops
from .ops.host_embed import embed_raster_host_packed
from .parallel.batch import hybrid_base_offsets_host
from .profiling import stage
from .utils import bits as bit_utils
from .utils.logging import get_logger

logger = get_logger("pipeline")

def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not yet ported to codec_tcc_tpu_torch "
        f"(ROADMAP.md, queue 1: {item})"
    )


def _check_ported(codec: str, version: int) -> None:
    if version == 1:
        raise _not_ported(
            "STGC container v1", "other codecs with v1 containers"
        )
    if codec.lower() in codec_names() and codec.lower() != "deflate":
        raise _not_ported(f"codec {codec!r}", "other codecs with v1 containers")


def _next_pow2(n: int) -> int:
    return 1 << max(0, (int(n) - 1)).bit_length()


def _plane_bucket(s: int, dtype_bits: int) -> int:
    """Plane count of the kernels' plan: 4, 8 or dtype width."""
    if s <= 4:
        return min(4, dtype_bits)
    if s <= 8:
        return min(8, dtype_bits)
    return dtype_bits


@dataclass
class EncodeResult:
    container: bytes
    stego: np.ndarray
    meta: container_io.ContainerMeta
    decomposition: decompose_ops.DecompositionResult
    metrics: Optional[Dict[str, float]] = None

    @property
    def s(self) -> int:
        return self.meta.s


@dataclass
class DecodeResult:
    payload_bits: np.ndarray
    stego: np.ndarray
    meta: container_io.ContainerMeta
    original: Optional[np.ndarray] = None   # restored via XOR maps if present

    @property
    def payload(self) -> bytes:
        return bit_utils.bits_to_bytes(self.payload_bits)

    @property
    def message(self) -> str:
        return self.payload.decode("utf-8", errors="replace")


def _as_payload_bits(payload: Union[bytes, str, np.ndarray]) -> np.ndarray:
    if isinstance(payload, str):
        return bit_utils.message_to_bits(payload)
    if isinstance(payload, (bytes, bytearray)):
        return bit_utils.bytes_to_bits(bytes(payload))
    return np.asarray(payload, dtype=np.uint8)


def _host_xor_maps(original: np.ndarray, stego: np.ndarray, s: int) -> np.ndarray:
    """(s, H, W) uint8 XOR location maps computed on host (the reference's
    ``orig ^ stego`` bitmaps, src/codec.py:309-311) — the raw-map branch for
    geometries with ``H*W % 8 != 0``, which the packed maps cannot hold."""
    diff = original ^ stego
    out = np.empty((s,) + diff.shape, np.uint8)
    for k in range(s):
        np.bitwise_and(diff >> k, 1, out=out[k], casting="unsafe")
    return out


def _block_bases(
    image: torch.Tensor, nbits: int, s: int, block: int, h: int, w: int
) -> np.ndarray:
    """``(nbits, ntiles) int32`` tile bases of the block fill order: the
    tile popcounts of planes ``0..s-1`` on the image's device, ranked on the
    host; rows at and past ``s`` are zero."""
    ntiles = (-(-h // block)) * (-(-w // block))
    base = np.zeros((nbits, ntiles), dtype=np.int32)
    counts = block_ops.block_bit_counts_all(image, s, block).cpu().numpy()
    for p in range(s):
        b, _ = block_ops.block_base_offsets(counts[p], h, w, block)
        base[p] = b
    return base


# Each embed route returns (stego, packed XOR maps or None, pair_stats
# moments or None); the maps come back only when the container stores them
# packed.


def _embed_raster(image_dev, msg_bits, pp, s, emit_maps, with_stats):
    """K1: stego + packed XOR maps in one launch, then the moments."""
    stego_dev, packed_dev = raster_kernels.raster_embed(
        image_dev, upload(msg_bits, image_dev.device), pp.starts,
        pp.lengths, pp.offsets, s, emit_maps=emit_maps,
    )
    stats = metric_ops.pair_stats(image_dev, stego_dev) if with_stats else None
    packed = None if packed_dev is None else packed_dev.cpu().numpy()
    return stego_dev.cpu().numpy(), packed, stats


def _embed_block(image_dev, msg_bits, pp, s, nbits, block, emit_maps,
                 with_stats):
    """block_adaptive on the image's device: the tile popcounts, the
    variance-ranked embed, the moments and the packed XOR maps."""
    h, w = image_dev.shape
    with stage("block_rank"):
        bases = _block_bases(image_dev, nbits, s, block, h, w)
    stego_dev = embed_ops.embed_block_adaptive(
        image_dev, upload(msg_bits, image_dev.device), bases, pp.lengths,
        pp.offsets, s, nbits, block,
    )
    stats = metric_ops.pair_stats(image_dev, stego_dev) if with_stats else None
    packed = None
    if emit_maps:
        packed = embed_ops.xor_maps_packed_batch(
            image_dev[None], stego_dev[None], s
        )[0].cpu().numpy()
    return stego_dev.cpu().numpy(), packed, stats


def _embed_host(image, msg_bits, pp, s, with_stats, dev):
    """The raster embed as O(payload) host window placement: no image
    upload. Metrics, when a forced "host" still asks for them, are the
    moments on the caller's device."""
    msg_pad = embed_ops.pad_message(
        msg_bits, image.size, int(pp.offsets.max(initial=0))
    )
    stego, packed = embed_raster_host_packed(
        image, msg_pad, pp.starts, pp.lengths, pp.offsets, s, max(s, 1)
    )
    stats = None
    if with_stats:
        stats = metric_ops.pair_stats(upload(image, dev), upload(stego, dev))
    return stego, packed, stats


# ---------------------------------------------------------------------------
# encode
# ---------------------------------------------------------------------------


def encode_array(
    image: np.ndarray,
    payload: Union[bytes, str, np.ndarray],
    config: EncodeConfig = EncodeConfig(),
    *,
    bits_stored: Optional[int] = None,
    device: DeviceLike = "cuda",
) -> EncodeResult:
    """Embed ``payload`` into ``image`` and build an STGC container."""
    config = config.validate()
    dev = resolve_device(device)
    _check_ported(config.codec, config.container_version)
    if config.strategy == "pee":
        # before the host-route check: as in the JAX package, PEE always
        # runs its passes on the device, whatever device_policy says
        from .models.pee import encode_pee_array

        return encode_pee_array(
            image, payload, config, bits_stored=bits_stored, device=dev
        )

    image = np.asarray(image)
    if image.ndim != 2 or image.dtype not in (np.uint8, np.uint16):
        raise ValueError("image must be 2-D uint8/uint16")
    h, w = image.shape
    n = h * w
    dtype_bits = image.dtype.itemsize * 8

    nbits = config.nbits
    if nbits is None:
        if config.use_bits_stored and bits_stored:
            nbits = bits_stored     # defect B6 fixed (opt-out via config)
        else:
            nbits = dtype_bits      # reference default (src/codec.py:567)
    nbits = min(nbits, dtype_bits)

    msg_bits = _as_payload_bits(payload)
    total_bits = int(msg_bits.size)

    # The route is the config's choice (resolve_host_route), not a
    # fallback. The device route uploads the image once: the histogram, the
    # block scans, the embed and the metric moments all read that copy. The
    # host route never uploads it; its histogram runs on the host, as the
    # JAX package's does for a numpy image.
    host_route = config.device_policy == "host" or config.resolve_host_route(n)
    image_t = upload(image, torch.device("cpu") if host_route else dev)

    # 1. decomposition: one histogram + exact host cut-point math
    with stage("decompose"):
        dec = decompose_ops.decompose(image_t, beta=config.beta, nbits=nbits)
    s = dec.s

    # 2. segment plan (host scalar work)
    plan = segment_ops.distribute_segments(s, total_bits, config.seed)
    dropped = total_bits - sum(min(e, n) for e in plan.eff_lengths)
    if dropped > 0 and not config.allow_capacity_overflow:
        raise CapacityError(
            f"payload of {total_bits} bits exceeds the usable capacity of "
            f"{segment_ops.usable_capacity_bits(s, n, config.seed)} bits at "
            f"s={s} ({dropped} bits would be silently dropped by the "
            f"per-plane clamp); shrink the payload, raise beta, or set "
            f"allow_capacity_overflow=True for reference-identical clamping"
        )

    # 3. strategy-specific plane plan (the hybrid start comes from the
    # block scan of plane 0)
    kernel_bits = _plane_bucket(s, dtype_bits)
    if host_route:
        # a forced "host" that the window form cannot serve raises here,
        # after the capacity check, as in the JAX package
        config.resolve_host_route(n)
    if config.strategy == "hybrid":
        with stage("block_scan"):
            if host_route:
                start = hybrid_base_offsets_host(
                    image[None], h, w, config.search_block_size
                )[0]
            else:
                counts0 = block_ops.block_bit_counts(
                    image_t, 0, config.search_block_size
                ).cpu().numpy()
                start = block_ops.best_offset_from_counts(
                    counts0, h, w, config.search_block_size
                )
        pp = segment_ops.raster_plane_plan(
            plan, n, kernel_bits, start, config.align_across_planes
        )
    else:  # multi_plane, block_adaptive
        pp = segment_ops.raster_plane_plan(plan, n, kernel_bits, 0, True)

    # v2.1 bit-packed maps when the geometry packs; raw maps otherwise
    bitmaps_packed = config.store_bitmaps and n % 8 == 0
    with stage("embed"):
        # 4. stego, the packed XOR maps (when the container stores them
        # packed) and the metric moments
        if host_route:
            stego, packed_maps, stats = _embed_host(
                image, msg_bits, pp, s, config.compute_metrics, dev
            )
        elif config.strategy == "block_adaptive":
            stego, packed_maps, stats = _embed_block(
                image_t, msg_bits, pp, s, kernel_bits, config.block_size,
                bitmaps_packed, config.compute_metrics,
            )
        else:
            stego, packed_maps, stats = _embed_raster(
                image_t, msg_bits, pp, s, bitmaps_packed,
                config.compute_metrics,
            )
        metrics = None if stats is None else metric_ops.quality_report(stats)

    # 5. transport codec + container
    with stage("transport_codec"):
        codec = get_codec(config.codec)
        stego_blob = codec.encode(stego)
        if not config.store_bitmaps:
            bitmaps_blob = b""
        elif bitmaps_packed:
            bitmaps_blob = container_io.compress_bitmaps_packed(packed_maps)
        else:
            bitmaps_blob = container_io.compress_bitmaps(
                _host_xor_maps(image, stego, s)
            )

    ext = b""
    if config.strategy == "block_adaptive":
        ext = container_io.pack_block_ext(config.block_size)

    meta = container_io.ContainerMeta(
        version=config.container_version,
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
        ext=ext,
    )
    blob = container_io.pack(meta, bitmaps_blob, stego_blob)

    logger.info(
        "encoded: s=%d strategy=%s codec=%s payload=%d bits container=%d bytes",
        s, config.strategy, config.codec, total_bits, len(blob),
    )
    return EncodeResult(
        container=blob, stego=stego, meta=meta, decomposition=dec, metrics=metrics
    )


def encode_dicom(
    path: str,
    payload: Union[bytes, str, np.ndarray],
    config: EncodeConfig = EncodeConfig(),
    *,
    device: DeviceLike = "cuda",
) -> EncodeResult:
    """Encode a DICOM file (BitsStored plumbed through)."""
    image, ds = dicom.load_image(path)
    if image.dtype == np.int16:
        image = image.astype(np.uint16)
    return encode_array(
        image, payload, config, bits_stored=ds.bits_stored, device=device
    )


def encode_file(
    path: str,
    payload: Union[bytes, str, np.ndarray],
    config: EncodeConfig = EncodeConfig(),
    *,
    device: DeviceLike = "cuda",
) -> EncodeResult:
    """Encode any supported image file: DICOM through the native reader
    (BitsStored plumbed through), PNG/PIL grayscale formats otherwise."""
    if path.lower().endswith(".dcm"):
        image, ds = dicom.load_image(path)
        if image.ndim == 3:
            raise ValueError(
                f"{path} is a multi-frame DICOM ({image.shape[0]} frames); "
                f"use encode-volume / parallel.volume for volumes"
            )
        if image.dtype == np.int16:
            image = image.astype(np.uint16)
        return encode_array(
            image, payload, config, bits_stored=ds.bits_stored, device=device
        )
    from PIL import Image

    arr = np.array(Image.open(path))
    if arr.dtype == np.int32:
        arr = arr.astype(np.uint16)
    return encode_array(arr, payload, config, device=device)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def _plane_plan_from_meta(meta: container_io.ContainerMeta, n: int, kernel_bits: int):
    """Rebuild the device plan from container metadata alone (no re-derivation
    from the seed needed — v2 stores the resolved plan)."""
    starts = np.zeros(kernel_bits, dtype=np.int32)
    lengths = np.zeros(kernel_bits, dtype=np.int32)
    offsets = np.zeros(kernel_bits, dtype=np.int32)
    # message offsets replay the reference's cumulative walk in segment order
    bit_idx = 0
    for plane in meta.indices:
        offsets[plane] = max(bit_idx, 0)
        # sizes are plane-indexed in both versions (the reference walks
        # distributed_sizes[dest_plane_idx] in segment order, codec.py:269-272)
        bit_idx += meta.sizes[plane]
    for plane in range(meta.s):
        lengths[plane] = meta.eff_lengths[plane]
    if meta.version == 1:
        # v1 stores only the base start_offset + align flag; replay the
        # hybrid strategy's sequential-advance walk (src/codec.py:482-485)
        offset = meta.start_offset % n if n else 0
        for plane in meta.indices:
            starts[plane] = offset
            if not meta.align_across_planes:
                offset = (offset + min(int(lengths[plane]), n)) % n
    else:
        for plane in range(meta.s):
            starts[plane] = meta.plane_starts[plane]
    return starts, lengths, offsets


def decode_container(
    data: Union[bytes, container_io.Container],
    *,
    restore_original: bool = True,
    device: DeviceLike = "cuda",
) -> DecodeResult:
    dev = resolve_device(device)
    cont = container_io.parse(data) if isinstance(data, (bytes, bytearray)) else data
    meta = cont.meta
    _check_ported(meta.codec, meta.version)
    if meta.strategy == "pee":
        from .models.pee import decode_pee_container

        return decode_pee_container(
            cont, restore_original=restore_original, device=dev
        )

    with stage("transport_decode"):
        codec = get_codec(meta.codec)
        stego = codec.decode(cont.stego_blob)
    if stego.dtype != meta.dtype:
        stego = stego.astype(meta.dtype)
    h, w = meta.height, meta.width
    if stego.shape != (h, w):
        raise ValueError(f"Decoded stego shape {stego.shape} != header {(h, w)}")
    n = h * w
    kernel_bits = _plane_bucket(meta.s, stego.dtype.itemsize * 8)

    starts, lengths, offsets = _plane_plan_from_meta(meta, n, kernel_bits)
    out_len = max(int(meta.payload_bits), 1)

    if meta.strategy == "block_adaptive":
        # on the host, as in the JAX package: the fill order is ranked from
        # the restored original, so the maps come first
        diff = cont.diff(stego.dtype)
        if diff is None:
            raise ValueError(
                "block_adaptive extraction requires the XOR location maps"
            )
        block = container_io.parse_block_ext(meta.ext)
        original = stego ^ diff
        with stage("extract"):
            counts = host_extract.block_counts_host(original, meta.s, block)
            rankings = [
                block_ops.ranking_from_counts(counts[p], h, w, block)
                for p in range(meta.s)
            ]
            bits = host_extract.extract_block_host(
                stego, rankings, lengths, offsets, meta.s, block, out_len,
            )[: meta.payload_bits]
        return DecodeResult(
            bits, stego, meta, original if restore_original else None
        )

    with stage("extract"):
        # K2 reads only the payload's pixels and writes them in message
        # order: the only download is the payload itself
        bits = raster_kernels.raster_extract(
            upload(stego, dev), starts, lengths, offsets, meta.s, out_len
        ).cpu().numpy()[: meta.payload_bits]

    original = None
    if restore_original and meta.has_bitmaps:
        with stage("restore"):
            # O(payload) window restore for raster v2.1 containers (exact
            # full-diff fallback otherwise — container.restore_original)
            original = cont.restore_original(stego)
    return DecodeResult(bits, stego, meta, original)


def decode_file(
    path: str, *, restore_original: bool = True, device: DeviceLike = "cuda"
) -> DecodeResult:
    with open(path, "rb") as f:
        return decode_container(
            f.read(), restore_original=restore_original, device=device
        )


# ---------------------------------------------------------------------------
# capacity planning
# ---------------------------------------------------------------------------


def load_input(path: str) -> Tuple[np.ndarray, Optional[int]]:
    """Image array + BitsStored (``None`` for non-DICOM): one shared input
    prologue for the CLI ``capacity`` subcommand, so every entry point
    answers identically for the same file."""
    if path.lower().endswith(".dcm"):
        arr, ds = dicom.load_image(path)
        return arr, ds.bits_stored
    from .cli import _load_any

    return _load_any(path), None


def capacity_report(
    arr: np.ndarray,
    *,
    bits_stored: Optional[int] = None,
    beta: float = 0.4,
    seed: int = 42,
    nbits: Optional[int] = None,
    use_bits_stored: bool = True,
    pee_threshold: int = 2,
    device: DeviceLike = "cuda",
) -> Dict:
    """Usable payload capacity per strategy, without encoding anything.

    Reports the boundary the encoders accept: the quadratic segment
    distribution's usable bits for the LSB strategies (NOT the reference's
    ``s*H*W`` claim, codec.py:294, which oversubscribes plane 0; included
    as ``reference_rule_bits`` for contrast) and the saturated two-pass
    probe for PEE (K3, pass-1 capacity measured on the pass-0 result). 3-D
    inputs use :func:`parallel.volume.encode_volume`'s semantics: one GLOBAL
    cut point, per-slice chunks. The histograms and the probe run on
    ``device``."""
    from .models import get_embedder

    dev = resolve_device(device)
    arr = np.asarray(arr)
    dtype_bits = arr.dtype.itemsize * 8
    if nbits is None:
        eff_nbits = (
            bits_stored if (bits_stored and use_bits_stored) else dtype_bits
        )
    else:
        eff_nbits = nbits
    eff_nbits = min(eff_nbits, dtype_bits)
    t = max(1, pee_threshold)

    out: Dict = {
        "shape": list(arr.shape),
        "dtype": str(arr.dtype),
        "bits_stored": bits_stored,
        "beta": beta,
        "nbits": eff_nbits,
        "pee_threshold": t,
    }
    if arr.ndim == 3:
        from .parallel.batch_pee import probe_capacity_batch
        from .parallel.volume import volume_cut_point

        d, h, w = arr.shape
        s, _ = volume_cut_point(arr, beta, device=dev)
        out["cut_point_s"] = int(s)
        out["frames"] = d
        out["lsb_bits"] = int(
            segment_ops.usable_capacity_bits(s, h * w, seed)
        ) * d
        # the volume PEE encoder embeds with the full-dtype max_val (STGV
        # volumes carry no BitsStored), so the report probes with the same
        # bound to be the boundary the encoder accepts
        max_val = (1 << dtype_bits) - 1
        out["pee_bits"] = int(np.sum(
            probe_capacity_batch(arr, t, max_val, device=dev)))
        out["reference_rule_bits"] = int(s) * h * w * d
    else:
        dec = decompose_ops.decompose(upload(arr, dev), beta=beta,
                                      nbits=eff_nbits)
        out["cut_point_s"] = int(dec.s)
        out["lsb_bits"] = int(
            segment_ops.usable_capacity_bits(dec.s, arr.size, seed)
        )
        pee = get_embedder(
            "pee", beta=beta, seed=seed, nbits=nbits,
            use_bits_stored=use_bits_stored, pee_threshold=t, device=dev,
        )
        out["pee_bits"] = int(pee.capacity_bits(arr, bits_stored=bits_stored))
        out["reference_rule_bits"] = int(dec.s) * arr.size
    return out


# ---------------------------------------------------------------------------
# analyze
# ---------------------------------------------------------------------------


def analyze_pair(
    original,
    stego,
    *,
    range_a: Optional[float] = None,
    range_b: Optional[float] = None,
    max_value: Optional[float] = None,
    device: DeviceLike = "cuda",
) -> Dict[str, float]:
    """Quality metrics for an image pair: delegates to
    :func:`codec_tcc_tpu_torch.ops.metrics.analyze_pair` (data-max range
    policy by default; pass BitsStored-derived ranges for the reference's
    file branch, or ``max_value`` to override only the final PSNR/SSIM
    range), with the moments on ``device``."""
    return metric_ops.analyze_pair(
        original, stego, range_a=range_a, range_b=range_b, max_value=max_value,
        device=device,
    )
