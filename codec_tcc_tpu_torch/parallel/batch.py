# Port of codec_tcc_tpu/parallel/batch.py on one device. The same code:
# BatchPlan, plan_batch, _msg_prefix, hybrid_base_offsets_host,
# BatchEncodeResult, _pack_batch_result, _group_decode_stegos,
# _decode_block_group and _decode_raster_group. Torch: batched_histograms,
# encode_batch, extract_aligned_batch, extract_batch, the block batch
# (_batch_block_bases, _block_embed_batch, _block_extract_batch; the
# popcounts are ops.blocks.block_bit_counts_all over the batch),
# _batch_quality_reports, hybrid_base_offsets,
# encode_batch_containers and decode_batch_containers. The JAX package's
# kernel tiers (_pick_pallas_backend, the packed and preplaced layouts) are
# one kernel here: K1 raster_embed_batch and K2 raster_extract_batch, one
# launch per batch. A `mesh` raises (ROADMAP.md, queue 1: multi-device).
"""Batched raster encode/extract and the container-level batch pipeline.

A batch of images is a ``(B, H, W)`` array of one geometry and dtype. Per-
image *plans* (cut point, segment windows) are host work: each image's
histogram gives its cut point through the exact float64 replay, and the
plane plans go to the device as ``(B, NP) int32`` arrays. The device work
is one kernel launch per batch: K1 :func:`~..ops.raster_kernels.
raster_embed_batch` writes every stego and its bit-packed XOR maps, K2
:func:`~..ops.raster_kernels.raster_extract_batch` reads every payload back
in message order.

:func:`encode_batch_containers` and :func:`decode_batch_containers` are the
serving path: one upload, one plan, one embed launch and one map download
for the whole batch, with the host shell (transport codec, STGC packing)
spread over a thread pool. Containers are byte-identical to the single-image
pipeline's and to the JAX package's.

Every entry point takes ``device`` (default ``"cuda"``); the CPU runs the
kernels' plain versions, and only when a caller passes ``"cpu"``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from ..config import EncodeConfig
from ..device import to_device, upload
from ..errors import CapacityError
from ..ops import decompose as decompose_ops
from ..ops import embed as embed_ops
from ..ops import histogram as hist_ops
from ..ops import raster_kernels
from ..ops import segments as segment_ops
from ..utils import bits as bit_utils

__all__ = [
    "BatchPlan", "plan_batch", "encode_batch", "extract_batch",
    "extract_aligned_batch", "batched_histograms", "hybrid_base_offsets",
    "hybrid_base_offsets_host", "BatchEncodeResult",
    "encode_batch_containers", "decode_batch_containers",
]


def _synchronize(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.current_stream(dev).synchronize()


def batched_histograms(images, nbins: int, *, device="cuda") -> np.ndarray:
    """(B, H, W) -> (B, nbins) exact histograms, one ``bincount`` per image
    on the device that holds the batch (a numpy batch is uploaded to
    ``device`` first); returned as numpy int64."""
    from .batch_pee import _resolve

    imgs = images if isinstance(images, torch.Tensor) else to_device(
        images, _resolve(device, None))
    return torch.stack([
        hist_ops.value_histogram(im, nbins) for im in imgs
    ]).cpu().numpy()


@dataclass
class BatchPlan:
    s: np.ndarray            # (B,) per-image cut points
    starts: np.ndarray       # (B, nbits)
    lengths: np.ndarray      # (B, nbits)
    offsets: np.ndarray      # (B, nbits)
    msgs: np.ndarray         # (B, Lpad) padded message bits
    payload_bits: np.ndarray # (B,)
    nbits: int
    lpad: int
    # container-packing extras (filled by plan_batch; explicit-plan builders
    # like parallel.volume may leave the defaults)
    base_offsets: Optional[np.ndarray] = None   # (B,) hybrid start offsets
    align: bool = True
    seed: int = 42


def plan_batch(
    images: np.ndarray,
    payloads: Sequence[Union[bytes, str, np.ndarray]],
    config: EncodeConfig = EncodeConfig(),
    *,
    histograms: Optional[np.ndarray] = None,
    nbits: Optional[int] = None,
    base_offsets: Optional[Sequence[int]] = None,
) -> BatchPlan:
    """Host-side planning for a batch: per-image decomposition (from one
    histogram per image) + segment plans, padded to a common ``Lpad``.

    ``config.strategy`` selects ``multi_plane`` (every plane starts at
    raster 0), ``hybrid`` (per-image variance-chosen start offset from the
    plane-0 tile popcounts) or ``block_adaptive`` (multi_plane-shaped plan;
    the variance-ranked tile placement is per-image embed state, not plan
    state). PEE goes through :mod:`.batch_pee`.

    ``nbits`` caps the decomposition's plane search like the single-image
    pipeline's BitsStored-derived cap; None decomposes over the full dtype
    width. ``histograms`` and ``base_offsets`` (hybrid) supply precomputed
    per-image values, so planning needs no device: the serving path takes
    them from the host-resident batch. Without them the histograms and the
    hybrid scan run on the card (:func:`batched_histograms`,
    :func:`hybrid_base_offsets`)."""
    b, h, w = images.shape
    n = h * w
    itemsize = np.dtype(images.dtype).itemsize
    dtype_bits = itemsize * 8
    max_val = 255 if itemsize == 1 else 65535
    if nbits is not None and nbits < 1:
        raise ValueError(f"nbits must be >= 1, got {nbits}")
    dec_nbits = dtype_bits if nbits is None else min(nbits, dtype_bits)

    if histograms is None:
        histograms = np.asarray(batched_histograms(images, max_val + 1))

    bit_arrays: List[np.ndarray] = []
    for p in payloads:
        if isinstance(p, str):
            bit_arrays.append(bit_utils.message_to_bits(p))
        elif isinstance(p, (bytes, bytearray)):
            bit_arrays.append(bit_utils.bytes_to_bits(bytes(p)))
        else:
            bit_arrays.append(np.asarray(p, dtype=np.uint8))

    s_arr = np.zeros(b, dtype=np.int32)
    payload_bits = np.array([int(x.size) for x in bit_arrays], dtype=np.int64)
    plans = []
    # decompose only reads the dtype and size once the histogram is given:
    # a zero-alloc host proxy stands in for each image
    img_proxy = np.broadcast_to(np.zeros((), dtype=images.dtype), (h, w))
    for i in range(b):
        dec = decompose_ops.decompose(
            img_proxy, beta=config.beta, nbits=dec_nbits,
            histogram_counts=histograms[i], full_curve=False,
        )
        s_arr[i] = dec.s
        plans.append(
            segment_ops.distribute_segments(dec.s, int(payload_bits[i]), config.seed)
        )

    # bucket the plane count to the batch's largest cut point
    from ..pipeline import _plane_bucket

    nbits = _plane_bucket(int(s_arr.max(initial=1)), dtype_bits)

    if config.strategy == "hybrid":
        if base_offsets is None:
            base_offsets = hybrid_base_offsets(
                images, h, w, config.search_block_size
            )
        align = config.align_across_planes
    elif config.strategy in ("multi_plane", "block_adaptive"):
        # block_adaptive shares the multi_plane raster plan (start 0,
        # aligned segments); its variance-ranked placement happens in the
        # embed via per-image tile bases, not in the plan
        base_offsets = [0] * b
        align = True
    else:
        raise ValueError(
            f"batch planning supports raster strategies only, not "
            f"'{config.strategy}' (use the single-image pipeline)"
        )

    starts = np.zeros((b, nbits), dtype=np.int32)
    lengths = np.zeros((b, nbits), dtype=np.int32)
    offsets = np.zeros((b, nbits), dtype=np.int32)
    max_need = 0
    for i in range(b):
        pp = segment_ops.raster_plane_plan(plans[i], n, nbits, base_offsets[i], align)
        starts[i] = pp.starts
        lengths[i] = pp.lengths
        offsets[i] = pp.offsets
        max_need = max(max_need, int(pp.offsets.max(initial=0)) + n, int(payload_bits[i]))

    lpad = 1 << max(3, (max_need - 1).bit_length())
    msgs = np.zeros((b, lpad), dtype=np.uint8)
    for i, bits in enumerate(bit_arrays):
        msgs[i, : bits.size] = bits

    return BatchPlan(
        s=s_arr, starts=starts, lengths=lengths, offsets=offsets,
        msgs=msgs, payload_bits=payload_bits, nbits=nbits, lpad=lpad,
        base_offsets=np.asarray(base_offsets, dtype=np.int64), align=align,
        seed=config.seed,
    )


def _batch_block_bases(
    imgs_dev, nbits: int, s_arr: np.ndarray, block: int, h: int, w: int
) -> np.ndarray:
    """Per-image, per-plane variance-ranked tile base offsets for the
    block_adaptive batch: one popcount pass over every (image, plane) on
    the device, then the exact integer-key host ranking per plane. Rows for
    planes >= s_i stay zero (their segment lengths are zero)."""
    from ..ops import blocks as block_ops

    b = imgs_dev.shape[0]
    max_s = max(int(s_arr.max(initial=1)), 1)
    counts = block_ops.block_bit_counts_all(imgs_dev, max_s,
                                            block).cpu().numpy()
    ntiles = (-(-h // block)) * (-(-w // block))
    bases = np.zeros((b, nbits, ntiles), dtype=np.int32)
    for i in range(b):
        for p in range(int(s_arr[i])):
            bases[i, p] = block_ops.block_base_offsets(
                counts[i, p], h, w, block
            )[0]
    return bases


def _block_embed_batch(imgs, msgs, bases, lengths, offsets, s, nbits: int,
                       block: int) -> torch.Tensor:
    """The variance-ranked block embed of every image of the batch, on its
    device: :func:`..ops.embed.embed_block_adaptive` per image."""
    return torch.stack([
        embed_ops.embed_block_adaptive(
            imgs[i], msgs[i], bases[i], lengths[i], offsets[i], int(s[i]),
            nbits, block,
        )
        for i in range(imgs.shape[0])
    ])


def _block_extract_batch(stegos, bases, lengths, offsets, s, nbits: int,
                         block: int, out_len: int) -> torch.Tensor:
    """``(B, out_len)`` payload bits of a block_adaptive batch on its
    device: :func:`..ops.embed.extract_block_message_device` per image."""
    return torch.stack([
        embed_ops.extract_block_message_device(
            stegos[i], bases[i], lengths[i], offsets[i], int(s[i]), nbits,
            block, out_len,
        )
        for i in range(stegos.shape[0])
    ])


def _msg_prefix(plan: "BatchPlan") -> np.ndarray:
    """Payload-covering prefix of ``plan.msgs``: ``plan.msgs`` carries +N
    window slack, but the kernels read message bits past a row's end as 0,
    so ship only a power-of-two prefix covering every message offset
    (offsets never exceed the payload size)."""
    p2 = 1 << max(
        3,
        int(max(plan.payload_bits.max(initial=1),
                plan.offsets.max(initial=0) + 1) - 1).bit_length(),
    )
    return plan.msgs[:, : min(p2, plan.msgs.shape[1])]


def encode_batch(
    images,
    plan: BatchPlan,
    mesh=None,
    backend: str = "auto",
    *,
    device="cuda",
) -> torch.Tensor:
    """Batched raster embed: ``(B, H, W)`` stego on ``device`` (a tensor
    input stays on its device's copy), one K1 launch for the batch.

    ``backend`` is accepted as the JAX package accepts it; every tier there
    computes this one function, so every value runs K1 (its plain version
    on the CPU)."""
    from .batch_pee import _resolve

    dev = _resolve(device, mesh)
    imgs = to_device(images, dev)
    stego, _ = raster_kernels.raster_embed_batch(
        imgs, to_device(_msg_prefix(plan), dev), plan.starts, plan.lengths,
        plan.offsets, plan.s, emit_maps=False,
    )
    return stego


def extract_aligned_batch(
    stego,
    plan: BatchPlan,
    mesh=None,
    *,
    device="cuda",
) -> torch.Tensor:
    """``(B, nbits, H*W)`` aligned plane rows: row ``p`` holds plane ``p``'s
    bits rotated back to message order and masked to its window and to
    ``p < s``. One K2 launch, with each plane's window moved to message
    offset ``p * H*W`` so that the planes' rows do not overlap."""
    from .batch_pee import _resolve

    dev = _resolve(device, mesh)
    st = to_device(stego, dev)
    b = st.shape[0]
    n = int(np.prod(st.shape[1:]))
    nbits = plan.nbits
    rows_off = np.broadcast_to(np.arange(nbits, dtype=np.int64) * n,
                               (b, nbits))
    lens = np.clip(np.asarray(plan.lengths, np.int64), 0, n)
    bits = raster_kernels.raster_extract_batch(
        st, plan.starts, lens, rows_off, plan.s, nbits * n
    )
    return bits.reshape(b, nbits, n)


def extract_batch(
    stego,
    plan: BatchPlan,
    mesh=None,
    out_len: Optional[int] = None,
    backend: str = "auto",
    *,
    device="cuda",
) -> np.ndarray:
    """``(B, out_len)`` message bits from one K2 launch: only the payload
    itself comes back from the device. The length the kernel writes is
    bucketed to the next power of two and sliced back on the host, as in
    the JAX package. ``backend`` is accepted and computes the same
    function (see :func:`encode_batch`)."""
    from ..pipeline import _next_pow2
    from .batch_pee import _resolve

    dev = _resolve(device, mesh)
    out_len = out_len or plan.lpad
    pad_len = _next_pow2(max(out_len, 1))
    bits = raster_kernels.raster_extract_batch(
        to_device(stego, dev), plan.starts, plan.lengths, plan.offsets, plan.s,
        pad_len,
    )
    return bits.cpu().numpy()[:, :out_len]


# ---------------------------------------------------------------------------
# container-level batch pipeline (the serving path)
#
# One device launch embeds the whole batch (and one extracts it), with the
# host shell (transport codec, XOR maps, STGC packing) spread over a thread
# pool. Containers are byte-identical to the single-image pipeline's, so the
# two paths interoperate freely.
# ---------------------------------------------------------------------------


def _batch_quality_reports(images, stego, dev: torch.device) -> list:
    """Per-image quality reports from one batched moments pass on ``dev``
    (numpy inputs are uploaded there)."""
    from ..ops import metrics as metric_ops

    stats = metric_ops.pair_stats(to_device(images, dev), to_device(stego, dev))
    stats_np = {k: v.cpu().numpy() for k, v in stats.items()}
    return [
        metric_ops.quality_report({k: v[i] for k, v in stats_np.items()})
        for i in range(len(stats_np["sum_sqdiff"]))
    ]


def hybrid_base_offsets_host(
    images: np.ndarray, h: int, w: int, search_block: int
) -> list:
    """Pure-numpy twin of :func:`hybrid_base_offsets`: plane-0 tile
    popcounts (zero-padded reshape-sum, the same zeros-contribute-nothing
    convention as ``ops.blocks.block_bit_counts_all``) + the exact
    integer-key ranking. Popcounts are integers, so the chosen offsets are
    identical to the device scan's, and the host route needs no image on
    the device."""
    from ..ops import blocks as block_ops

    b = images.shape[0]
    bs = search_block
    nh, nw = -(-h // bs), -(-w // bs)
    bits = (images & 1).astype(np.uint8)
    if (nh * bs, nw * bs) != (h, w):
        bits = np.pad(bits, ((0, 0), (0, nh * bs - h), (0, nw * bs - w)))
    counts = bits.reshape(b, nh, bs, nw, bs).sum(axis=(2, 4), dtype=np.int64)
    return [
        block_ops.best_offset_from_counts(counts[i], h, w, bs)
        for i in range(b)
    ]


def hybrid_base_offsets(images, h: int, w: int, search_block: int, *,
                        device="cuda") -> list:
    """Per-image variance-chosen hybrid start offsets: the plane-0 tile
    popcounts of the whole batch in one pass on the device that holds it (a
    numpy batch is uploaded to ``device`` first), then the exact host
    ranking. Shared by the batch planner and the volume encoder:
    both write the offset into container metadata."""
    from ..ops import blocks as block_ops
    from .batch_pee import _resolve

    imgs = images if isinstance(images, torch.Tensor) else to_device(
        images, _resolve(device, None))
    counts = block_ops.block_bit_counts_all(
        imgs, 1, search_block)[:, 0].cpu().numpy()
    return [
        block_ops.best_offset_from_counts(counts[i], h, w, search_block)
        for i in range(counts.shape[0])
    ]


@dataclass
class BatchEncodeResult:
    stego: np.ndarray                       # (B, H, W)
    containers: List[bytes]                 # one STGC-v2 per image
    plan: Optional[BatchPlan]               # None for the PEE delegation
    metrics: Optional[List[dict]] = None    # per-image quality reports


def encode_batch_containers(
    images: np.ndarray,
    payloads: Sequence[Union[bytes, str, np.ndarray]],
    config: EncodeConfig = EncodeConfig(),
    mesh=None,
    *,
    bits_stored: Optional[int] = None,
    device="cuda",
) -> BatchEncodeResult:
    """Encode a ``(B, H, W)`` batch into one STGC-v2 container per image.

    Raster strategies run as one K1 launch for the batch (stego and packed
    XOR maps); ``block_adaptive`` as the block batch in torch ops; ``pee``
    delegates to :func:`.batch_pee.encode_pee_batch`. ``device_policy``
    routes the raster strategies as the single-image pipeline does
    (``EncodeConfig.resolve_host_route``): the host route places the
    payloads with numpy windows and uploads nothing."""
    from ..pipeline import _check_ported
    from ..profiling import stage
    from .batch_pee import _resolve

    config = config.validate()
    dev = _resolve(device, mesh)
    if config.container_version != 2:
        raise ValueError("batch container encoding writes v2 containers only")
    _check_ported(config.codec, config.container_version)
    if config.strategy == "pee":
        from .batch_pee import encode_pee_batch

        r = encode_pee_batch(
            images, payloads, config, bits_stored=bits_stored, device=dev
        )
        metrics = None
        if config.compute_metrics:
            # the same per-image quality reports as the raster branch
            metrics = _batch_quality_reports(images, r.stego, dev)
        return BatchEncodeResult(
            stego=r.stego, containers=r.containers, plan=None, metrics=metrics,
        )

    images = np.asarray(images)
    b, h, w = images.shape
    n = h * w
    dtype_bits = images.dtype.itemsize * 8
    nbits = config.nbits
    if nbits is None:
        nbits = bits_stored if (config.use_bits_stored and bits_stored) else dtype_bits
    nbits = min(nbits, dtype_bits)

    # the route is the config's choice, shared with the single-image
    # pipeline: "auto" keeps the device for block_adaptive and device metrics
    host_route = config.resolve_host_route(n)

    if not host_route:
        # one host->device transfer feeds the block scans, the embed and
        # the metric moments
        with stage("batch_upload"):
            imgs_dev = upload(images, dev)
    with stage("batch_plan"):
        # device-free planning, as in the JAX package: host bincount
        # histograms and the numpy hybrid scan of the host-resident batch
        max_val = 255 if images.dtype.itemsize == 1 else 65535
        hists = np.stack([
            np.bincount(im.reshape(-1), minlength=max_val + 1)
            for im in images
        ])
        host_offsets = (
            hybrid_base_offsets_host(images, h, w, config.search_block_size)
            if config.strategy == "hybrid" else None
        )
        plan = plan_batch(
            images, payloads, config, histograms=hists, nbits=nbits,
            base_offsets=host_offsets,
        )

    if not config.allow_capacity_overflow:
        for i in range(b):
            have = int(plan.lengths[i, : plan.s[i]].sum())
            if have < int(plan.payload_bits[i]):
                raise CapacityError(
                    f"payload {i} of {int(plan.payload_bits[i])} bits exceeds "
                    f"the usable capacity of {have} bits at s={int(plan.s[i])}; "
                    f"shrink it, raise beta, or set allow_capacity_overflow=True"
                )

    max_s = int(plan.s.max(initial=0))

    if host_route:
        from ..ops.host_embed import embed_raster_host_packed

        with stage("batch_embed"):
            packed = np.zeros((b, max(max_s, 1), n // 8), dtype=np.uint8)
            stego = np.empty_like(images)
            for i in range(b):
                stego[i], packed[i] = embed_raster_host_packed(
                    images[i], plan.msgs[i], plan.starts[i],
                    plan.lengths[i], plan.offsets[i], int(plan.s[i]),
                    max(max_s, 1),
                )
        metrics = None
        if config.compute_metrics:
            metrics = _batch_quality_reports(images, stego, dev)
        return _pack_batch_result(
            images, stego, packed, plan, config, nbits, bits_stored, h, w,
            metrics,
        )

    packed_dev = None
    with stage("batch_upload_wait"):
        _synchronize(dev)
    with stage("batch_embed"):
        msgs_dev = upload(_msg_prefix(plan), dev)
        if config.strategy == "block_adaptive":
            # variance-ranked placement: per-image tile bases (one popcount
            # pass + exact host ranking), then the block embed per image
            bases = _batch_block_bases(
                imgs_dev, plan.nbits, plan.s, config.block_size, h, w
            )
            stego_dev = _block_embed_batch(
                imgs_dev, msgs_dev, bases, plan.lengths, plan.offsets,
                plan.s, plan.nbits, config.block_size,
            )
        else:
            # K1: every stego and, where the geometry packs, its maps over
            # max_s planes, in one launch
            stego_dev, packed_dev = raster_kernels.raster_embed_batch(
                imgs_dev, msgs_dev, plan.starts, plan.lengths, plan.offsets,
                plan.s, emit_maps=n % 8 == 0, max_s=max_s,
            )
        _synchronize(dev)

    metrics = None
    if config.compute_metrics:
        metrics = _batch_quality_reports(imgs_dev, stego_dev, dev)
    if n % 8 == 0:
        # download the bit-packed XOR maps of the first max(s) planes, not
        # the stego batch: they are the v2.1 container bitmap blobs, and
        # the stego is rebuilt on the host as orig ^ diff
        with stage("batch_download"):
            packed = (
                packed_dev if packed_dev is not None
                else embed_ops.xor_maps_packed_batch(imgs_dev, stego_dev,
                                                     max_s)
            ).cpu().numpy()
        with stage("batch_unpack"):
            stego = np.empty_like(images)
            if config.strategy in ("multi_plane", "hybrid"):
                # O(payload) window reconstruction: the raster diffs are
                # all-zero outside each plane's window
                for i in range(b):
                    stego[i] = bit_utils.xor_packed_windows(
                        images[i], packed[i],
                        plan.starts[i], plan.lengths[i],
                    )
            else:
                # block_adaptive diffs scatter over the ranked tiles: the
                # full expansion per image into the preallocated output
                for i in range(b):
                    diff_i = bit_utils.packed_planes_to_diff(
                        packed[i], images.dtype
                    )
                    np.bitwise_xor(
                        images[i], diff_i.reshape(h, w), out=stego[i]
                    )
    else:
        packed = None
        with stage("batch_download"):
            stego = stego_dev.cpu().numpy()

    return _pack_batch_result(
        images, stego, packed, plan, config, nbits, bits_stored, h, w,
        metrics,
    )


def _pack_batch_result(
    images: np.ndarray,
    stego: np.ndarray,
    packed: Optional[np.ndarray],
    plan: "BatchPlan",
    config: EncodeConfig,
    nbits: int,
    bits_stored: Optional[int],
    h: int,
    w: int,
    metrics: Optional[List[dict]],
) -> "BatchEncodeResult":
    """Shared container-pack tail of :func:`encode_batch_containers`: the
    host zlib/container shell is identical whether the XOR maps came off
    the device (packed download) or from the O(payload) host embed."""
    from concurrent.futures import ThreadPoolExecutor

    from ..profiling import stage
    from ..utils.pool import host_workers

    from ..io import container as container_io
    from ..io.codecs import get as get_codec
    from ..pipeline import _host_xor_maps

    b = images.shape[0]
    codec = get_codec(config.codec)

    def pack_one(i: int) -> bytes:
        s = int(plan.s[i])
        seg = segment_ops.distribute_segments(
            s, int(plan.payload_bits[i]), config.seed
        )
        # the packed maps are the v2.1 blobs' zlib input as they are
        packed_i = packed[i, :s] if packed is not None else None
        maps = (
            None if packed_i is not None
            else _host_xor_maps(images[i], stego[i], s)
        )
        meta = container_io.ContainerMeta(
            version=2, codec=config.codec, strategy=config.strategy,
            s=s, nbits=nbits, bits_stored=bits_stored or nbits,
            dtype=images.dtype, width=w, height=h,
            start_offset=int(plan.base_offsets[i]),
            seed=config.seed,
            payload_bits=int(plan.payload_bits[i]),
            align_across_planes=plan.align,
            has_bitmaps=config.store_bitmaps,
            bitmaps_packed=config.store_bitmaps and packed_i is not None,
            sizes=seg.sizes, indices=seg.indices,
            eff_lengths=tuple(int(v) for v in plan.lengths[i, :s]),
            plane_starts=tuple(int(v) for v in plan.starts[i, :s]),
            ext=(container_io.pack_block_ext(config.block_size)
                 if config.strategy == "block_adaptive" else b""),
        )
        if not config.store_bitmaps:
            bitmaps_blob = b""
        elif packed_i is not None:
            bitmaps_blob = container_io.compress_bitmaps_packed(packed_i)
        else:
            bitmaps_blob = container_io.compress_bitmaps(maps)
        return container_io.pack(meta, bitmaps_blob, codec.encode(stego[i]))

    with stage("batch_pack"):
        with ThreadPoolExecutor(max_workers=host_workers(b)) as pool:
            containers = list(pool.map(pack_one, range(b)))
    return BatchEncodeResult(
        stego=stego, containers=containers, plan=plan, metrics=metrics
    )


def decode_batch_containers(
    containers: Sequence[bytes],
    mesh=None,
    *,
    restore_original: bool = True,
    device="cuda",
) -> List:
    """Batched decode: containers group by ``(geometry, dtype, codec,
    version, strategy)``. PEE groups decode through
    :func:`.batch_pee.decode_pee_batch` (K4); raster and block_adaptive
    groups on the host, as in the JAX package (the stego batch is
    host-resident straight out of the transport codec, and only payload
    bits would come back from the device). Other groups (v1, codecs still
    to port, bitmap-less block_adaptive) go through
    ``pipeline.decode_container`` per item, which raises what the
    single-image decoder raises. Returns ``pipeline.DecodeResult`` objects
    in input order."""
    from ..io import container as container_io
    from ..pipeline import decode_container
    from .batch_pee import _resolve

    dev = _resolve(device, mesh)
    if not containers:
        raise ValueError("Invalid file: empty container batch")
    conts = [
        c if isinstance(c, container_io.Container) else container_io.parse(c)
        for c in containers
    ]
    groups: dict = {}
    for i, c in enumerate(conts):
        key = (c.meta.width, c.meta.height, str(np.dtype(c.meta.dtype)),
               c.meta.codec, c.meta.version, c.meta.strategy)
        groups.setdefault(key, []).append(i)
    results: List = [None] * len(conts)
    for idxs in groups.values():
        sub = [conts[i] for i in idxs]
        m0 = sub[0].meta
        ported = m0.version == 2 and m0.codec.lower() == "deflate"
        if ported and m0.strategy == "pee":
            from .batch_pee import decode_pee_batch

            outs = decode_pee_batch(
                sub, restore_original=restore_original, device=dev
            )
        elif ported and m0.strategy in ("multi_plane", "hybrid"):
            outs = _decode_raster_group(sub, None, restore_original)
        elif (ported and m0.strategy == "block_adaptive"
              and all(c.meta.has_bitmaps for c in sub)):
            # (missing bitmaps -> the per-item path below raises the
            # single-image decoder's descriptive error)
            outs = _decode_block_group(sub, restore_original)
        else:
            outs = [
                decode_container(c, restore_original=restore_original,
                                 device=dev)
                for c in sub
            ]
        for i, r in zip(idxs, outs):
            results[i] = r
    return results


def _group_decode_stegos(conts: List) -> np.ndarray:
    """Threaded transport-codec decode + stack for a same-key container
    group, with the format-error contract and the ``batch_codec_decode``
    stage both group decoders' callers rely on."""
    from concurrent.futures import ThreadPoolExecutor

    from ..io.codecs import get as get_codec
    from ..profiling import stage
    from ..utils.pool import host_workers

    meta0 = conts[0].meta
    codec = get_codec(meta0.codec)
    with stage("batch_codec_decode"):
        with ThreadPoolExecutor(max_workers=host_workers(len(conts))) as pool:
            stegos = list(pool.map(
                lambda c: codec.decode(c.stego_blob).astype(meta0.dtype),
                conts,
            ))
    shape = (meta0.height, meta0.width)
    for st in stegos:
        if st.shape != shape:
            raise ValueError(
                f"Invalid file: decoded stego shape {st.shape} != header "
                f"{shape}"
            )
    return np.stack(stegos)


def _decode_block_group(conts: List, restore_original: bool) -> List:
    """Batched decode for a same-key group of v2 block_adaptive containers:
    per-image original from the XOR maps (host LUT), then host extraction
    (tile popcounts + exact integer ranking + O(payload) fill-position
    gathers, ``ops.host_extract``). Bit-identical to
    ``pipeline.decode_container`` per item."""
    from ..io import container as container_io
    from ..ops import host_extract
    from ..ops import blocks as block_ops
    from ..pipeline import DecodeResult, _plane_plan_from_meta
    from ..profiling import stage

    meta0 = conts[0].meta
    stego = _group_decode_stegos(conts)
    diffs = np.stack([c.diff(stego.dtype) for c in conts])
    original = stego ^ diffs

    h, w = meta0.height, meta0.width
    results: List = [None] * len(conts)
    with stage("batch_extract"):
        for i, c in enumerate(conts):
            meta = c.meta
            s = int(meta.s)
            block = container_io.parse_block_ext(meta.ext)
            _, lengths, offsets = _plane_plan_from_meta(meta, h * w, max(s, 1))
            counts = host_extract.block_counts_host(original[i], s, block)
            rankings = [
                block_ops.ranking_from_counts(counts[p], h, w, block)
                for p in range(s)
            ]
            bits = host_extract.extract_block_host(
                stego[i], rankings, lengths, offsets, s, block,
                max(int(meta.payload_bits), 1),
            )[: int(meta.payload_bits)]
            results[i] = DecodeResult(
                payload_bits=bits,
                stego=stego[i],
                meta=meta,
                original=original[i] if restore_original else None,
            )
    return results


def _decode_raster_group(
    conts: List,
    mesh,
    restore_original: bool,
) -> List:
    """Batched decode for a same-key group of v2 multi_plane/hybrid
    containers: host numpy window slices
    (``ops.host_extract.extract_raster_host``, O(payload) per image) on
    the stego batch the transport codec left on the host."""
    from ..ops import host_extract
    from ..pipeline import _plane_plan_from_meta
    from ..pipeline import DecodeResult

    b = len(conts)
    meta0 = conts[0].meta
    h, w = meta0.height, meta0.width
    n = h * w

    from ..profiling import stage

    stego = _group_decode_stegos(conts)

    out_len = max(max(int(c.meta.payload_bits) for c in conts), 1)
    bits = np.zeros((b, out_len), dtype=np.uint8)
    with stage("batch_extract"):
        for i, c in enumerate(conts):
            s = int(c.meta.s)
            starts, lengths, offsets = _plane_plan_from_meta(
                c.meta, n, max(s, 1)
            )
            bits[i] = host_extract.extract_raster_host(
                stego[i], starts, lengths, offsets, s, out_len
            )

    results = []
    for i, c in enumerate(conts):
        original = None
        if restore_original and c.meta.has_bitmaps:
            with stage("batch_restore"):
                # O(payload) window restore (exact full-diff fallback
                # inside: container.restore_original)
                original = c.restore_original(stego[i])
        results.append(DecodeResult(
            payload_bits=np.asarray(
                bits[i, : int(c.meta.payload_bits)], dtype=np.uint8
            ),
            stego=stego[i],
            meta=c.meta,
            original=original,
        ))
    return results
