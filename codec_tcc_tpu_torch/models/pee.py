# Port of codec_tcc_tpu/models/pee.py: the XLA branch of the encoder and the
# decoder, on the caller's device. select_threshold and
# parse_pee_container_parts are copies of the originals; the decoders parse
# through parse_pee_container_packed, which keeps the overflow map packed.
"""PEE embedder model: pipeline + container integration.

Prediction-error expansion end to end, on top of :mod:`..ops.pee` and the
kernels K3/K4. The STGC v2 container carries it as strategy 4 with a PEE
extension block (threshold, passes, per-pass boundaries and bit counts)
and the overflow location map in the bitmaps slot.

Threshold selection is capacity-adaptive: the smallest ``T`` whose exact
pass-0 capacity plus the estimated pass-1 capacity holds the payload, read
off the capacity histograms, starting from the configured
``pee_threshold``; an attempt that falls short escalates ``T`` by one.
Containers are byte-identical to the JAX package's.
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional

import numpy as np
import torch

from ..config import EncodeConfig
from ..device import download, upload
from ..errors import CapacityError
from ..io import container as container_io
from ..io.codecs import get as get_codec
from ..ops import deflate_rle
from ..ops import embed as embed_ops
from ..ops import inflate
from ..ops import metrics as metric_ops
from ..ops import pee as pee_ops
from ..ops import pee_kernels
from ..ops.decompose import DecompositionResult
from ..profiling import count, stage
from ..utils.bits import bounded_inflate, expand_bits
from ..utils.logging import get_logger

logger = get_logger("models.pee")

_MAX_T = 128
_pack_ext = container_io.pack_pee_ext
_parse_ext = container_io.parse_pee_ext


# Copy of codec_tcc_tpu/models/pee.py::select_threshold (numpy only).
def select_threshold(cap0, cap1_est, total_bits: int, t_min: int = 1):
    """Smallest ``T >= t_min`` whose exact pass-0 capacity plus estimated
    pass-1 capacity holds the payload, read off the capacity histograms
    (:func:`ops.pee.capacities_by_threshold`). Returns ``None`` when even
    ``T = t_max`` falls short of the estimate.

    ``cap0`` is exact (the histogram excludes T-independent expansion
    overflow), so a payload within ``cap0[T-1]`` embeds in ONE pass.
    ``cap1_est`` is measured on the pristine image while pass 1 really runs
    on the pass-0 stego; the caller's escalate-on-shortfall loop absorbs
    the difference."""
    import numpy as np

    comb = np.asarray(cap0) + np.asarray(cap1_est)
    t_min = max(1, int(t_min))
    fits = np.nonzero(comb[t_min - 1 :] >= total_bits)[0]
    if fits.size == 0:
        return None
    return t_min + int(fits[0])


def max_value(image_max: int, dtype_bits: int, eff_bits: int) -> int:
    """The pixel ceiling of the passes: BitsStored's, or the dtype's when
    the image exceeds it."""
    max_val = (1 << eff_bits) - 1
    if image_max > max_val:
        max_val = (1 << dtype_bits) - 1
    return max_val


def message_buffer(bit_arrays, device) -> torch.Tensor:
    """``(B, Lpad)`` uint8 message rows, zero-padded to the next power of
    two (at least 8) of the longest payload."""
    longest = max((int(x.size) for x in bit_arrays), default=1)
    lpad = 1 << max(3, (max(longest, 1) - 1).bit_length())
    msgs = np.zeros((len(bit_arrays), lpad), dtype=np.uint8)
    for i, bits in enumerate(bit_arrays):
        msgs[i, : bits.size] = bits
    return upload(msgs, device)


def encode_pee_array(
    image,
    payload,
    config: EncodeConfig,
    *,
    bits_stored: Optional[int] = None,
    device,
):
    from ..pipeline import EncodeResult, _as_payload_bits

    image = np.asarray(image)
    if image.ndim != 2 or image.dtype not in (np.uint8, np.uint16):
        raise ValueError("image must be 2-D uint8/uint16")
    h, w = image.shape
    dtype_bits = image.dtype.itemsize * 8
    eff_bits = bits_stored if (config.use_bits_stored and bits_stored) else dtype_bits
    max_val = max_value(int(image.max()), dtype_bits, eff_bits)

    msg_bits = _as_payload_bits(payload)
    total_bits = int(msg_bits.size)
    with stage("image_upload"):
        image_dev = upload(image, device)[None]
        msg_dev = message_buffer([msg_bits], device)
        want_dev = upload(np.array([total_bits], np.int32), device)

    # one histogram per pass gives the exact pass-0 capacity and the pass-1
    # estimate at every threshold; an attempt that falls short of the
    # estimate escalates T
    with stage("pee_histogram"):
        hist = download(torch.stack([
            pee_ops.capacity_histogram(image_dev[0], p, _MAX_T, max_val)
            for p in (0, 1)
        ]))
        cap0 = pee_ops.capacities_by_threshold(hist[0])
        cap1 = pee_ops.capacities_by_threshold(hist[1])
    t = select_threshold(cap0, cap1, total_bits, config.pee_threshold)
    if t is None:
        t = _MAX_T  # one exact attempt: the embed is the authority
    result = None
    with stage("embed"):
        while t <= _MAX_T:
            # both passes through K3, chained on the device; only the
            # used/nproc scalars come back to the host
            stego, over_dev, u0, n0, u1, n1 = pee_kernels.embed_both_passes(
                image_dev, msg_dev, want_dev, t, max_val
            )
            used0, nproc0, used1, nproc1 = (
                int(v) for v in download(torch.cat([u0, n0, u1, n1])))
            if used0 + used1 < total_bits:
                t += 1  # the estimate fell short by the pass interaction
                continue
            passes = 2 if used1 > 0 else 1
            result = (t, stego, over_dev, used0, nproc0, used1, nproc1, passes)
            break
        if result is None:
            raise CapacityError(
                f"payload of {total_bits} bits exceeds PEE capacity even at "
                f"T={_MAX_T} (pass-1 capacity measured on the pass-0 result)"
            )
        t, stego, over_dev, used0, nproc0, used1, nproc1, passes = result

        # the overflow map is packed on the device: its bytes are the
        # container blob's zlib input
        packed_over = download(embed_ops.pack_bits_batch(over_dev)[0])
        stats = (metric_ops.pair_stats(image_dev[0], stego[0])
                 if config.compute_metrics else None)
        stego_np = download(stego[0])
        metrics = None if stats is None else metric_ops.encode_report(
            {k: download(v) for k, v in stats.items()}, image, stego_np)

    with stage("transport_codec"):
        stego_bytes = deflate_rle.transport_encode(
            get_codec(config.codec), stego_np, stego[0])
        map_blob = zlib.compress(packed_over.tobytes())
        stego_blob = stego_bytes()
    ext = _pack_ext(t, passes, nproc0, nproc1, used0, used1)
    meta = container_io.ContainerMeta(
        version=2,
        codec=config.codec,
        strategy="pee",
        s=0,
        nbits=eff_bits,
        bits_stored=eff_bits,
        dtype=image.dtype,
        width=w,
        height=h,
        start_offset=0,
        seed=config.seed,
        payload_bits=total_bits,
        align_across_planes=False,
        has_bitmaps=True,
        sizes=(),
        indices=(),
        eff_lengths=(),
        plane_starts=(),
        ext=ext,
    )
    blob = container_io.pack(meta, map_blob, stego_blob)
    logger.info(
        "pee encoded: T=%d passes=%d bits=%d (pass0=%d pass1=%d) container=%d B",
        t, passes, total_bits, used0, used1, len(blob),
    )

    # decomposition result stub for API uniformity (PEE has no cut point)
    dec = DecompositionResult(
        s=0, nbits=eff_bits, entropy=0.0, target=0.0,
        mi=np.zeros(0), cumulative=np.zeros(0),
    )
    return EncodeResult(
        container=blob, stego=stego_np, meta=meta, decomposition=dec, metrics=metrics
    )


# Copy of codec_tcc_tpu/models/pee.py::parse_pee_container_parts (numpy only).
def parse_pee_container_parts(cont: container_io.Container):
    """Validate and unpack a PEE container's strategy parts with the
    'Invalid file: ...' ValueError contract (shared by the single-image and
    batched decoders). Returns ``(ext_tuple, overflow_bool_hw)``."""
    meta = cont.meta
    if len(meta.ext) < struct.calcsize(container_io._PEE_EXT_FMT):
        raise ValueError(
            "Invalid file: truncated PEE extension block "
            f"({len(meta.ext)} bytes, need "
            f"{struct.calcsize(container_io._PEE_EXT_FMT)})"
        )
    ext = _parse_ext(meta.ext)
    h, w = meta.height, meta.width
    # defense in depth: container.parse already rejects oversized dims, but
    # n below feeds the overflow-map inflate bound, so never trust a meta
    # that arrived by another route (the bound would scale with h*w and
    # expand_bits multiplies the inflated bytes 8x)
    container_io._check_dims(w, h, meta.s)
    t_val, passes, nproc0, nproc1, bits0, bits1 = ext
    n = h * w
    if not (1 <= t_val <= _MAX_T) or passes not in (1, 2):
        raise ValueError(
            f"Invalid file: PEE ext out of range (T={t_val}, passes={passes})"
        )
    if not (0 <= nproc0 <= n and 0 <= nproc1 <= n
            and 0 <= bits0 <= n and 0 <= bits1 <= n):
        raise ValueError(
            "Invalid file: PEE ext boundaries exceed the image size "
            f"({nproc0}, {nproc1}, {bits0}, {bits1} vs {n} pixels)"
        )
    if meta.payload_bits > bits0 + bits1:
        raise ValueError(
            f"Invalid file: payload_bits {meta.payload_bits} exceeds the "
            f"recorded pass totals ({bits0} + {bits1})"
        )
    from ..utils.bits import bounded_inflate, expand_bits

    # the map is pack_bits of n pixels (device packing may lane-pad the
    # tail); bound the untrusted inflate at that size plus the padding slack
    raw = bounded_inflate(
        cont.bitmaps_blob, (n + 7) // 8 + 4096, "PEE overflow map blob"
    )

    overflow = expand_bits(np.frombuffer(raw, dtype=np.uint8))
    if overflow.size < h * w:
        raise ValueError(
            f"Invalid file: PEE overflow map holds {overflow.size} bits, "
            f"image needs {h * w}"
        )
    return ext, overflow[: h * w].reshape(h, w).astype(bool)


def parse_pee_container_packed(cont: container_io.Container):
    """:func:`parse_pee_container_parts`' checks and ``Invalid file:``
    messages, without the map's expansion: returns ``(ext_tuple, raw)``,
    ``raw`` the inflated overflow map packed MSB-first over the flat image
    (at least ``ceil(h*w/8)`` bytes), for :func:`overflow_map_on`."""
    meta = cont.meta
    if len(meta.ext) < struct.calcsize(container_io._PEE_EXT_FMT):
        raise ValueError(
            "Invalid file: truncated PEE extension block "
            f"({len(meta.ext)} bytes, need "
            f"{struct.calcsize(container_io._PEE_EXT_FMT)})"
        )
    ext = _parse_ext(meta.ext)
    h, w = meta.height, meta.width
    # n feeds the inflate bound: never trust a meta that arrived by another
    # route than container.parse
    container_io._check_dims(w, h, meta.s)
    t_val, passes, nproc0, nproc1, bits0, bits1 = ext
    n = h * w
    if not (1 <= t_val <= _MAX_T) or passes not in (1, 2):
        raise ValueError(
            f"Invalid file: PEE ext out of range (T={t_val}, passes={passes})"
        )
    if not (0 <= nproc0 <= n and 0 <= nproc1 <= n
            and 0 <= bits0 <= n and 0 <= bits1 <= n):
        raise ValueError(
            "Invalid file: PEE ext boundaries exceed the image size "
            f"({nproc0}, {nproc1}, {bits0}, {bits1} vs {n} pixels)"
        )
    if meta.payload_bits > bits0 + bits1:
        raise ValueError(
            f"Invalid file: payload_bits {meta.payload_bits} exceeds the "
            f"recorded pass totals ({bits0} + {bits1})"
        )
    # the map is pack_bits of n pixels (device packing may lane-pad the
    # tail); bound the untrusted inflate at that size plus the padding slack
    raw = bounded_inflate(
        cont.bitmaps_blob, (n + 7) // 8 + 4096, "PEE overflow map blob"
    )
    if 8 * len(raw) < n:
        raise ValueError(
            f"Invalid file: PEE overflow map holds {8 * len(raw)} bits, "
            f"image needs {n}"
        )
    return ext, raw


def overflow_map_on(raw: bytes, h: int, w: int, dev) -> torch.Tensor:
    """The ``(h, w)`` uint8 overflow map on ``dev`` from the packed bytes of
    :func:`parse_pee_container_packed` (bits past ``h*w`` dropped). On a
    CUDA device the ``ceil(h*w/8)`` packed bytes go up and expand there
    (``pee.map_device``); elsewhere the host's LUT expands them
    (``pee.map_host``), many times faster than torch's shifts on a CPU."""
    n = h * w
    packed = np.frombuffer(raw, np.uint8, count=(n + 7) // 8)
    if torch.device(dev).type == "cuda":
        count("pee.map_device")
        bits = embed_ops.expand_bits_tensor(upload(packed, dev))
    else:
        count("pee.map_host")
        bits = upload(expand_bits(packed), dev)
    return bits[:n].view(h, w)


def decode_pee_container(
    cont: container_io.Container, *, restore_original: bool = True, device
):
    from ..pipeline import DecodeResult

    meta = cont.meta
    (t, passes, nproc0, nproc1, bits0, bits1), raw = (
        parse_pee_container_packed(cont)
    )
    with stage("transport_decode"):
        stego, stego_dev = inflate.transport_decode(
            get_codec(meta.codec), cont.stego_blob, device)
    if stego.dtype != meta.dtype:
        stego = stego.astype(meta.dtype)
        stego_dev = None
    h, w = meta.height, meta.width
    if stego.shape != (h, w):
        raise ValueError(f"Decoded stego shape {stego.shape} != header {(h, w)}")

    out_len = 1 << max(3, (max(int(meta.payload_bits), 1) - 1).bit_length())
    with stage("extract"):
        # invert pass 1 first (it was applied last), then pass 0, through
        # K4; a single-pass container must not have a pass-1 inversion
        # applied even if its ext carries a nonzero nproc1
        nproc = upload(np.array(
            [[nproc0], [nproc1 if passes == 2 else 0]], dtype=np.int32,
        ), device)
        img, b1, n1, b0, n0 = pee_kernels.extract_both_passes(
            (upload(stego, device) if stego_dev is None else stego_dev)[None],
            overflow_map_on(raw, h, w, device)[None],
            nproc[0], nproc[1], t, out_len,
        )
        n0, n1 = (int(v) for v in download(torch.cat([n0, n1])))
        bits = download(torch.cat([b0[0, :n0], b1[0, :n1]]))
        original = download(img[0]) if restore_original else None

    return DecodeResult(
        payload_bits=bits[: meta.payload_bits].astype(np.uint8),
        stego=stego,
        meta=meta,
        original=original,
    )
