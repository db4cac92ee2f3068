# Port of codec_tcc_tpu/parallel/batch_pee.py: every group runs through the
# kernels K3/K4 (the JAX package's Pallas route). The `backend` argument is
# gone (the device decides); a `mesh` splits the batch over its `dp` devices
# (mesh.dp_shards) where the JAX package shards it. Groups are not padded to
# a power-of-two size: that padding only spared the TPU compile cache, and
# no output depends on it; a group splits as its padding would, the last
# shards shorter or empty.
"""Batched PEE embedding with per-image thresholds.

Threshold selection is histogram-driven: one batched histogram per pass
gives every image's exact pass-0 capacity and pass-1 estimate at every
threshold, each image gets the smallest T whose combined capacity holds ITS
payload, and images sharing a T run both passes as one K3 launch each over
the subgroup. A pass-1 shortfall (the estimate's pass-interaction error)
escalates only the affected images. With a ``mesh``, the histograms run
per ``dp`` shard and each attempt group splits over the ``dp`` devices
where the JAX package shards it (its padded size a multiple of the mesh's
size), one K3 launch per pass per non-empty shard.

Each image gets its own self-contained STGC-v2 container (strategy 4,
per-image T in the PEE ext), byte-identical to the JAX package's, so any
decoder reads it; :func:`decode_pee_batch` decodes each group of equal
geometry and T with one K4 launch per pass.

Its stages take the raster batch route's names: ``batch_plan`` (the start
thresholds' histograms), ``batch_embed`` (the attempt groups) and
``batch_pack`` (the containers' zlib); in the decode ``batch_codec_decode``
and ``batch_extract`` (K4). Counters: ``pee.batch_groups`` per equal-T
attempt group, ``pee.batch_escalated`` per image re-queued at T + 1,
``pee.decode_groups`` per K4 group and ``pee.map_host`` per container.
"""

from __future__ import annotations

import zlib
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import List, Sequence, Union

import numpy as np
import torch

from ..config import EncodeConfig
from ..device import download, resolve_device, to_device, upload
from ..errors import CapacityError
from ..io import container as container_io
from ..io.codecs import get as get_codec
from ..models.pee import (
    _MAX_T,
    max_value,
    message_buffer,
    parse_pee_container_parts,
    select_threshold,
)
from ..ops import embed as embed_ops
from ..ops import pee as pee_ops
from ..ops import pee_kernels
from ..profiling import count, stage
from ..utils.logging import get_logger
from ..utils.pool import host_workers
from .mesh import device_guard, dp_shards

logger = get_logger("parallel.batch_pee")

__all__ = [
    "BatchPeeResult", "encode_pee_batch", "decode_pee_batch",
    "probe_capacity_batch",
]


@dataclass
class BatchPeeResult:
    stego: np.ndarray               # (B, H, W)
    containers: List[bytes]         # one STGC-v2 per image
    thresholds: np.ndarray          # (B,) per-image T
    used_bits: np.ndarray           # (B,) embedded bits

    @property
    def threshold(self) -> int:
        """Largest per-image threshold."""
        return int(self.thresholds.max())


def _rows(t: torch.Tensor, idxs) -> torch.Tensor:
    """``t[idxs]`` along dim 0, on the device. CUDA has no uint16 gather,
    so uint16 rows are taken through the int16 view (the same bits)."""
    sel = to_device(np.asarray(idxs, np.int64), t.device)
    if t.dtype == torch.uint16:
        return t.view(torch.int16)[sel].view(torch.uint16)
    return t[sel]


def _take_rows(parts, pos, dev: torch.device) -> torch.Tensor:
    """Items ``pos`` (in that order, repeats allowed) of a batch held as
    shards ``parts`` (``(rows, tensor)``), stacked on ``dev``."""
    pieces, order = [], []
    for rows, t in parts:
        local = [(k, p - rows.start) for k, p in enumerate(pos)
                 if rows.start <= p < rows.stop]
        if not local:
            continue
        ks, idx = zip(*local)
        whole = list(idx) == list(range(t.shape[0]))
        pieces.append((t if whole else _rows(t, idx)).to(dev))
        order.extend(ks)
    out = pieces[0] if len(pieces) == 1 else torch.cat(pieces)
    if order != sorted(order):
        out = _rows(out, np.argsort(order).tolist())
    return out


def probe_capacity_batch(
    images: np.ndarray, t: int, max_val: int, *, device="cuda"
) -> np.ndarray:
    """Saturated two-pass PEE capacity per image at shared threshold ``t``
    (``(B,)`` int64 bits). Runs both passes through K3 at ``want = 2**30``
    (pass-1 capacity measured on the actual pass-0 stego, so the pass
    interaction is counted): ``used = cap`` when ``want > cap``. The
    message is ``n/2`` zeros; message indices past it clamp."""
    dev = resolve_device(device)
    b, h, w = images.shape
    n = h * w
    big = torch.full((b,), 1 << 30, dtype=torch.int32, device=dev)
    lpad = max(8, n // 2)
    msgs = torch.zeros((b, lpad), dtype=torch.uint8, device=dev)
    _, _, u0, _, u1, _ = pee_kernels.embed_both_passes(
        upload(images, dev), msgs, big, t, max_val,
    )
    return download(u0).astype(np.int64) + download(u1).astype(np.int64)


def _start_thresholds(imgs, want, max_val: int, t_min: int) -> np.ndarray:
    """Per-image T of the first attempt, ``(B,)`` int32: the smallest T
    whose histogram capacity holds the payload, from one batched histogram
    per pass of the batch ``imgs`` on its device, or of each of its ``dp``
    shards (a list of tensors). A shortfall then escalates T by one per
    round."""
    with stage("batch_plan"):
        per_shard = []
        for part in (imgs if isinstance(imgs, list) else [imgs]):
            with device_guard(part.device):
                per_shard.append(torch.stack([
                    pee_ops.capacity_histogram(part, p, _MAX_T, max_val)
                    for p in (0, 1)
                ]))
        hist = np.concatenate([download(h) for h in per_shard], axis=1)
    cap0 = pee_ops.capacities_by_threshold(hist[0])
    cap1 = pee_ops.capacities_by_threshold(hist[1])
    t_img = np.zeros(len(want), dtype=np.int32)
    for i, bits in enumerate(want):
        t = select_threshold(cap0[i], cap1[i], int(bits), t_min)
        # an estimate shortfall even at T=128 still gets one exact attempt —
        # the embed itself is the authority, the histogram only schedules
        t_img[i] = _MAX_T if t is None else t
    return t_img


def _launch_passes(images, msgs, want: np.ndarray, t: int, max_val: int):
    """Both PEE passes over one same-threshold subgroup (or its shard) on
    its device, launched and not waited on: ``(stego, packed overflow (G,
    ceil(HW/8)) u8, (4, G) used0/nproc0/used1/nproc1)`` on the device. The
    overflow is bit-packed there, its bytes the container blob's zlib
    input. Wants go in unclamped (the passes clamp to capacity
    themselves)."""
    with device_guard(images.device):
        want_d = upload(want.astype(np.int32), images.device)
        s1, over, u0, n0, u1, n1 = pee_kernels.embed_both_passes(
            images, msgs, want_d, t, max_val
        )
        return (s1, embed_ops.pack_bits_batch(over),
                torch.stack([u0, n0, u1, n1]))


def _run_passes(img_parts, msg_parts, idxs, b: int, want: np.ndarray,
                t: int, mesh, max_val: int):
    """Both PEE passes over the attempt group ``idxs`` of a batch of ``b``,
    split over the ``dp`` devices where the JAX package shards it (the
    group's power-of-two size a multiple of the mesh's size), every shard
    launched before any is read back. Returns numpy ``(fits, stego, packed
    overflow, used0, nproc0, used1, nproc1)`` in ``idxs`` order: ``fits``
    marks the entries whose passes hold their payload, and only their stego
    and overflow rows come back from the device, as ``stego`` and
    ``overflow`` (an empty list where none fits); an entry that falls short
    runs again at T + 1."""
    g = len(idxs)
    g_pad = 1 << max(0, (g - 1).bit_length())
    lead = img_parts[0][1].device
    shards = (dp_shards(g, mesh, rows=g_pad)
              if mesh is not None and g_pad % mesh.size == 0
              else [(lead, slice(0, g))])
    # a group of b entries may hold an image twice (one that fell short at
    # T and at T + 1 in one round), so the message rows are always gathered
    # by idxs; the whole-batch image shortcut is the JAX package's, kept for
    # its bytes (ROADMAP queue 3, F1-ref)
    img_pos = list(range(b)) if g == b else list(idxs)
    runs = [
        _launch_passes(_take_rows(img_parts, img_pos[rows], dev),
                       _take_rows(msg_parts, list(idxs)[rows], dev),
                       want[rows], t, max_val)
        for dev, rows in shards if rows.stop > rows.start
    ]
    scalars = np.concatenate([download(r[2]) for r in runs],
                             axis=1).astype(np.int64)
    fits = scalars[0] + scalars[2] >= want
    stego, over, off = [], [], 0
    for s1, packed, _ in runs:
        sel = np.flatnonzero(fits[off:off + s1.shape[0]])
        off += s1.shape[0]
        if sel.size == s1.shape[0]:
            stego.append(download(s1))
            over.append(download(packed))
        elif sel.size:
            stego.append(download(_rows(s1, sel)))
            over.append(download(_rows(packed, sel)))
    if stego:
        stego, over = np.concatenate(stego), np.concatenate(over)
    return fits, stego, over, scalars[0], scalars[1], scalars[2], scalars[3]


def encode_pee_batch(
    images: np.ndarray,
    payloads: Sequence[Union[bytes, str, np.ndarray]],
    config: EncodeConfig = EncodeConfig(),
    mesh=None,
    *,
    bits_stored=None,
    device="cuda",
) -> BatchPeeResult:
    from ..pipeline import _as_payload_bits

    b, h, w = images.shape
    # the JAX package shards the histogram pass's batch over dp: a batch
    # that does not split evenly raises there, and here
    shards = dp_shards(b, mesh, device)
    dtype_bits = np.dtype(images.dtype).itemsize * 8
    eff_bits = bits_stored if (config.use_bits_stored and bits_stored) else dtype_bits
    max_val = max_value(int(images.max()), dtype_bits, eff_bits)

    bit_arrays = [_as_payload_bits(p) for p in payloads]
    want = np.array([x.size for x in bit_arrays], dtype=np.int64)
    msgs = message_buffer(bit_arrays, "cpu")
    img_parts = [(rows, upload(images[rows], dev)) for dev, rows in shards]
    msg_parts = [(rows, to_device(msgs[rows], dev)) for dev, rows in shards]

    t_img = _start_thresholds([t for _, t in img_parts], want, max_val,
                              config.pee_threshold)
    stego = np.empty_like(images)
    overflow = np.zeros((b, (h * w + 7) // 8), dtype=np.uint8)  # bit-packed
    used0 = np.zeros(b, np.int64)
    used1 = np.zeros(b, np.int64)
    nproc0 = np.zeros(b, np.int64)
    nproc1 = np.zeros(b, np.int64)
    pending = list(range(b))
    with stage("batch_embed"):
        while pending:
            next_pending: List[int] = []
            for t in sorted({int(t_img[i]) for i in pending}):
                idxs = [i for i in pending if int(t_img[i]) == t]
                count("pee.batch_groups")
                fits, g_stego, g_over, g_u0, g_n0, g_u1, g_n1 = _run_passes(
                    img_parts, msg_parts, idxs, b, want[idxs], t, mesh,
                    max_val,
                )
                if fits.any():
                    done = np.asarray(idxs)[fits]
                    stego[done], overflow[done] = g_stego, g_over
                    used0[done], used1[done] = g_u0[fits], g_u1[fits]
                    nproc0[done], nproc1[done] = g_n0[fits], g_n1[fits]
                for i in np.asarray(idxs)[~fits].tolist():
                    if t >= _MAX_T:
                        raise CapacityError(
                            f"payload {i} of {int(want[i])} bits exceeds "
                            f"the PEE capacity even at T={_MAX_T}"
                        )
                    t_img[i] = t + 1
                    next_pending.append(i)
                    count("pee.batch_escalated")
            pending = next_pending

    codec = get_codec(config.codec)

    def pack_one(i: int) -> bytes:
        passes = 2 if used1[i] > 0 else 1
        ext = container_io.pack_pee_ext(
            int(t_img[i]), passes, int(nproc0[i]), int(nproc1[i]),
            int(used0[i]), int(used1[i]),
        )
        meta = container_io.ContainerMeta(
            version=2, codec=config.codec, strategy="pee", s=0,
            nbits=eff_bits, bits_stored=eff_bits, dtype=images.dtype,
            width=w, height=h, start_offset=0, seed=config.seed,
            payload_bits=int(want[i]), align_across_planes=False,
            has_bitmaps=True, sizes=(), indices=(), eff_lengths=(),
            plane_starts=(), ext=ext,
        )
        map_blob = zlib.compress(overflow[i].tobytes())
        return container_io.pack(meta, map_blob, codec.encode(stego[i]))

    with stage("batch_pack"):
        with ThreadPoolExecutor(max_workers=host_workers(b)) as pool:
            containers = list(pool.map(pack_one, range(b)))

    logger.info(
        "pee batch: B=%d T=%s total_bits=%d devices=%s",
        b, sorted(set(t_img.tolist())), int(want.sum()),
        [str(dev) for dev, _ in shards],
    )
    return BatchPeeResult(
        stego=stego, containers=containers, thresholds=t_img,
        used_bits=used0 + used1,
    )


def decode_pee_batch(
    containers: Sequence[bytes], *, restore_original: bool = True,
    device="cuda",
):
    """Batched decode of PEE containers, the counterpart of
    :func:`encode_pee_batch`. Containers are grouped by (geometry,
    BitsStored, dtype, codec, threshold); each group decodes with one K4
    launch per pass. Returns ``pipeline.DecodeResult`` in input order."""
    dev = resolve_device(device)
    conts = [
        c if isinstance(c, container_io.Container) else container_io.parse(c)
        for c in containers
    ]
    parsed_ext = []
    overflow_maps = []
    groups: dict = {}
    for j, c in enumerate(conts):
        if c.meta.strategy != "pee":
            raise ValueError(f"not a PEE container (strategy={c.meta.strategy})")
        # shared hardened parsing: 'Invalid file: ...' ValueErrors on
        # truncated ext blocks / corrupt or short overflow maps
        ext, over = parse_pee_container_parts(c)
        parsed_ext.append(ext)
        overflow_maps.append(over)
        key = (c.meta.width, c.meta.height, c.meta.bits_stored,
               str(np.dtype(c.meta.dtype)), c.meta.codec, ext[0])
        groups.setdefault(key, []).append(j)
    count("pee.map_host", len(conts))

    results: List = [None] * len(conts)
    for idxs in groups.values():
        count("pee.decode_groups")
        group_res = _decode_group_fused(
            [conts[j] for j in idxs],
            [parsed_ext[j] for j in idxs],
            [overflow_maps[j] for j in idxs],
            restore_original,
            dev,
        )
        for j, r in zip(idxs, group_res):
            results[j] = r
    return results


def _decode_group_fused(conts, parsed_ext, overflow_maps, restore_original,
                        dev):
    """Decode one homogeneous (shared-key) container group through K4."""
    from ..pipeline import DecodeResult

    b = len(conts)
    w, h = conts[0].meta.width, conts[0].meta.height
    t = parsed_ext[0][0]
    dtype = conts[0].meta.dtype
    codec = get_codec(conts[0].meta.codec)

    with stage("batch_codec_decode"):
        with ThreadPoolExecutor(max_workers=host_workers(b)) as pool:
            stegos = list(pool.map(
                lambda c: codec.decode(c.stego_blob).astype(dtype), conts
            ))
    for s in stegos:
        if s.shape != (h, w):
            raise ValueError(
                f"Decoded stego shape {s.shape} != header {(h, w)}")
    stego = np.stack(stegos)
    over = np.stack(overflow_maps)
    with stage("batch_extract"):
        # same guard as the single-image decoder: a 1-pass container must
        # not have a pass-1 inversion applied even if its ext carries a
        # (foreign/corrupt) nonzero nproc1
        nproc = upload(np.array(
            [[e[2] for e in parsed_ext],
             [e[3] if e[1] == 2 else 0 for e in parsed_ext]],
            dtype=np.int32,
        ), dev)
        out_len = max(int(max(e[4] for e in parsed_ext)),
                      int(max(e[5] for e in parsed_ext)), 1)
        r0, bits1, _, bits0, _ = pee_kernels.extract_both_passes(
            upload(stego, dev), upload(over, dev),
            nproc[0], nproc[1], t, out_len,
        )
        restored = download(r0) if restore_original else None
        bits0 = download(bits0)
        bits1 = download(bits1)

    results = []
    for i, c in enumerate(conts):
        _, _, _, _, b0, b1 = parsed_ext[i]
        payload = np.concatenate(
            [bits0[i, :b0], bits1[i, :b1]]
        )[: c.meta.payload_bits].astype(np.uint8)
        results.append(DecodeResult(
            payload_bits=payload,
            stego=stego[i],
            meta=c.meta,
            original=restored[i] if restore_original else None,
        ))
    logger.info("pee batch decode: B=%d T=%d", b, t)
    return results
