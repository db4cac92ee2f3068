# Port of codec_tcc_tpu/parallel/batch_pee.py on one device: every group
# runs through the kernels K3/K4 (the JAX package's Pallas route). The
# `backend` argument is gone (the device decides), a `mesh` raises, and
# groups are not padded to a power-of-two size: that padding only spared the
# TPU compile cache, and no output depends on it.
"""Batched PEE embedding with per-image thresholds.

Threshold selection is histogram-driven: one batched histogram per pass
gives every image's exact pass-0 capacity and pass-1 estimate at every
threshold, each image gets the smallest T whose combined capacity holds ITS
payload, and images sharing a T run both passes as one K3 launch each over
the subgroup. A pass-1 shortfall (the estimate's pass-interaction error)
escalates only the affected images.

Each image gets its own self-contained STGC-v2 container (strategy 4,
per-image T in the PEE ext), byte-identical to the JAX package's, so any
decoder reads it; :func:`decode_pee_batch` decodes each group of equal
geometry and T with one K4 launch per pass.
"""

from __future__ import annotations

import zlib
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import List, Sequence, Union

import numpy as np
import torch

from ..config import EncodeConfig
from ..device import resolve_device
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
from ..profiling import stage
from ..utils.logging import get_logger
from ..utils.pool import host_workers

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
    sel = torch.tensor(idxs, device=t.device)
    if t.dtype == torch.uint16:
        return t.view(torch.int16)[sel].view(torch.uint16)
    return t[sel]


def _resolve(device, mesh) -> torch.device:
    if mesh is not None:
        raise NotImplementedError(
            "multi-device (mesh) batches over the 'dp' axis are not yet "
            "ported to codec_tcc_tpu_torch (ROADMAP.md, queue 1: "
            "multi-device); one image across a mesh's 'tile' axis is "
            "parallel.tile / parallel.tile_pee"
        )
    return resolve_device(device)


def probe_capacity_batch(
    images: np.ndarray, t: int, max_val: int, *, device="cuda"
) -> np.ndarray:
    """Saturated two-pass PEE capacity per image at shared threshold ``t``
    (``(B,)`` int64 bits). Runs both passes through K3 at ``want = 2**30``
    (pass-1 capacity measured on the actual pass-0 stego, so the pass
    interaction is counted): ``used = cap`` when ``want > cap``. The
    message is ``n/2`` zeros; message indices past it clamp."""
    dev = _resolve(device, None)
    b, h, w = images.shape
    n = h * w
    big = torch.full((b,), 1 << 30, dtype=torch.int32, device=dev)
    lpad = max(8, n // 2)
    msgs = torch.zeros((b, lpad), dtype=torch.uint8, device=dev)
    _, _, u0, _, u1, _ = pee_kernels.embed_both_passes(
        torch.from_numpy(np.ascontiguousarray(images)).to(dev), msgs, big, t,
        max_val,
    )
    return u0.cpu().numpy().astype(np.int64) + u1.cpu().numpy().astype(np.int64)


def _start_thresholds(imgs: torch.Tensor, want, max_val: int,
                      t_min: int) -> np.ndarray:
    """Per-image T of the first attempt, ``(B,)`` int32: the smallest T
    whose histogram capacity holds the payload, from one batched histogram
    per pass. A shortfall then escalates T by one per round."""
    with stage("pee_histogram"):
        hist = torch.stack([
            pee_ops.capacity_histogram(imgs, p, _MAX_T, max_val)
            for p in (0, 1)
        ]).cpu().numpy()
    cap0 = pee_ops.capacities_by_threshold(hist[0])
    cap1 = pee_ops.capacities_by_threshold(hist[1])
    t_img = np.zeros(len(want), dtype=np.int32)
    for i, bits in enumerate(want):
        t = select_threshold(cap0[i], cap1[i], int(bits), t_min)
        # an estimate shortfall even at T=128 still gets one exact attempt —
        # the embed itself is the authority, the histogram only schedules
        t_img[i] = _MAX_T if t is None else t
    return t_img


def _run_passes(images, msgs, want: np.ndarray, t: int, max_val: int):
    """Both PEE passes over one same-threshold subgroup on its device.
    Returns numpy ``(stego, packed overflow (G, ceil(HW/8)) u8, used0,
    nproc0, used1, nproc1)``; the overflow is bit-packed on the device, its
    bytes the container blob's zlib input. Wants go in unclamped (the
    passes clamp to capacity themselves)."""
    want_d = torch.from_numpy(want.astype(np.int32)).to(images.device)
    s1, over, u0, n0, u1, n1 = pee_kernels.embed_both_passes(
        images, msgs, want_d, t, max_val
    )
    scalars = torch.stack([u0, n0, u1, n1]).cpu().numpy().astype(np.int64)
    return (
        s1.cpu().numpy(), embed_ops.pack_bits_batch(over).cpu().numpy(),
        scalars[0], scalars[1], scalars[2], scalars[3],
    )


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

    dev = _resolve(device, mesh)
    b, h, w = images.shape
    dtype_bits = np.dtype(images.dtype).itemsize * 8
    eff_bits = bits_stored if (config.use_bits_stored and bits_stored) else dtype_bits
    max_val = max_value(int(images.max()), dtype_bits, eff_bits)

    bit_arrays = [_as_payload_bits(p) for p in payloads]
    want = np.array([x.size for x in bit_arrays], dtype=np.int64)
    msgs_dev = message_buffer(bit_arrays, dev)
    imgs_dev = torch.from_numpy(np.ascontiguousarray(images)).to(dev)

    t_img = _start_thresholds(imgs_dev, want, max_val, config.pee_threshold)
    stego = np.empty_like(images)
    overflow = np.zeros((b, (h * w + 7) // 8), dtype=np.uint8)  # bit-packed
    used0 = np.zeros(b, np.int64)
    used1 = np.zeros(b, np.int64)
    nproc0 = np.zeros(b, np.int64)
    nproc1 = np.zeros(b, np.int64)
    pending = list(range(b))
    with stage("embed"):
        while pending:
            next_pending: List[int] = []
            for t in sorted({int(t_img[i]) for i in pending}):
                idxs = [i for i in pending if int(t_img[i]) == t]
                # a group of b entries may hold an image twice (one that
                # fell short at T and at T + 1 in one round), so the
                # message rows are always gathered by idxs; the whole-batch
                # image shortcut is the JAX package's, kept for its bytes
                # (ROADMAP queue 3, F1-ref)
                sub_imgs = imgs_dev if len(idxs) == b else _rows(imgs_dev,
                                                                 idxs)
                sub_msgs = _rows(msgs_dev, idxs)
                g_stego, g_over, g_u0, g_n0, g_u1, g_n1 = _run_passes(
                    sub_imgs, sub_msgs, want[idxs], t, max_val,
                )
                for k, i in enumerate(idxs):
                    if g_u0[k] + g_u1[k] >= want[i]:
                        stego[i] = g_stego[k]
                        overflow[i] = g_over[k]
                        used0[i], used1[i] = g_u0[k], g_u1[k]
                        nproc0[i], nproc1[i] = g_n0[k], g_n1[k]
                    else:
                        if t >= _MAX_T:
                            raise CapacityError(
                                f"payload {i} of {int(want[i])} bits exceeds "
                                f"the PEE capacity even at T={_MAX_T}"
                            )
                        t_img[i] = t + 1
                        next_pending.append(i)
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

    with stage("transport_codec"):
        with ThreadPoolExecutor(max_workers=host_workers(b)) as pool:
            containers = list(pool.map(pack_one, range(b)))

    logger.info(
        "pee batch: B=%d T=%s total_bits=%d device=%s",
        b, sorted(set(t_img.tolist())), int(want.sum()), dev,
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
    dev = _resolve(device, None)
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

    results: List = [None] * len(conts)
    for idxs in groups.values():
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

    with stage("transport_decode"):
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
    with stage("extract"):
        # same guard as the single-image decoder: a 1-pass container must
        # not have a pass-1 inversion applied even if its ext carries a
        # (foreign/corrupt) nonzero nproc1
        nproc = torch.tensor(
            [[e[2] for e in parsed_ext],
             [e[3] if e[1] == 2 else 0 for e in parsed_ext]],
            dtype=torch.int32, device=dev,
        )
        out_len = max(int(max(e[4] for e in parsed_ext)),
                      int(max(e[5] for e in parsed_ext)), 1)
        r0, bits1, _, bits0, _ = pee_kernels.extract_both_passes(
            torch.from_numpy(stego).to(dev), torch.from_numpy(over).to(dev),
            nproc[0], nproc[1], t, out_len,
        )
        restored = r0.cpu().numpy() if restore_original else None
        bits0 = bits0.cpu().numpy()
        bits1 = bits1.cpu().numpy()

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
