# Port of codec_tcc_tpu/io/container.py: the same code; only import lines and prose differ.
"""STGC container format — v1 (reference-compatible) and v2 (native).

Reference format (``src/codec.py:601-750``):

    b"STGC" | >I header_len | header | bitmaps_blob | compressed_stego
    header = >BBBBHHH (version=1, codec_id, s, align_flag, width, height,
             start_offset) + {s}H segment_lengths + {s}B segment_indices
             + I bitmaps_blob_size

v1 is kept for interchange, with its verified limits intact (defect B5:
``>H`` caps start_offset and per-segment lengths at 65,535 — below the
262,143 max raster offset of even a 512x512 image).

**v2** is the native format (SURVEY §2.4 B5 disposition: "widen to >I ... keep
a version byte"): 32-bit geometry/offsets/lengths, signed planned sizes (the
reference's excess correction can legitimately produce a negative bucket),
explicit strategy/seed/dtype/bits-stored fields so a decoder can rebuild the
exact embedding plan without re-deriving anything, and an extension block for
strategy-specific parameters (block size, PEE threshold...). Layout:

    b"STGC" | >I header_len | header_v2 | bitmaps_blob | stego_blob
    header_v2 =
      >BBBBBBBB  version=2, codec_id, strategy, s, nbits, bits_stored,
                 dtype_code (1=u8, 2=u16), flags (bit0: align_across_planes,
                 bit1: has_bitmaps, bit2: bitmaps bit-PACKED before zlib —
                 v2.1, written whenever H*W % 8 == 0: the blob deflates the
                 ``np.packbits`` form of the planes, 8x less zlib input
                 and smaller containers; readers accept both forms, so
                 older v2 files keep decoding)
      >IIII      width, height, start_offset, seed
      >Q         payload_bits
      {s}i       planned sizes           (plane-indexed, may be negative)
      {s}B       segment indices         (segment order k -> plane)
      {s}I       effective lengths       (plane-indexed, embedded bit counts)
      {s}I       plane start offsets     (plane-indexed)
      >I         ext_len | ext bytes     (strategy-specific)
      >I         bitmaps_blob_size
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

MAGIC = b"STGC"

STRATEGY_MULTI_PLANE = 1
STRATEGY_BLOCK_ADAPTIVE = 2
STRATEGY_HYBRID = 3
STRATEGY_PEE = 4

STRATEGY_NAMES = {
    STRATEGY_MULTI_PLANE: "multi_plane",
    STRATEGY_BLOCK_ADAPTIVE: "block_adaptive",
    STRATEGY_HYBRID: "hybrid",
    STRATEGY_PEE: "pee",
}
STRATEGY_IDS = {v: k for k, v in STRATEGY_NAMES.items()}

_V1_CODEC_NAMES = {1: "png", 2: "j2k", 3: "jls", 4: "jxl"}
_CODEC_NAMES = {**_V1_CODEC_NAMES, 5: "deflate"}
_CODEC_IDS = {v: k for k, v in _CODEC_NAMES.items()}

FLAG_ALIGN = 1
FLAG_HAS_BITMAPS = 2
FLAG_PACKED_BITMAPS = 4     # v2.1: bitmap blob is zlib of bit-PACKED planes

_DTYPE_CODES = {np.dtype(np.uint8): 1, np.dtype(np.uint16): 2}
_CODE_DTYPES = {1: np.dtype(np.uint8), 2: np.dtype(np.uint16)}


@dataclass
class ContainerMeta:
    version: int
    codec: str
    strategy: str
    s: int
    nbits: int
    bits_stored: int
    dtype: np.dtype
    width: int
    height: int
    start_offset: int
    seed: int
    payload_bits: int
    align_across_planes: bool
    has_bitmaps: bool
    sizes: Tuple[int, ...]          # planned, plane-indexed (v2) / seg lens (v1)
    indices: Tuple[int, ...]        # segment order k -> plane
    eff_lengths: Tuple[int, ...]    # plane-indexed
    plane_starts: Tuple[int, ...]   # plane-indexed
    ext: bytes = b""
    bitmaps_packed: bool = False    # v2 only: blob holds bit-packed planes

    @property
    def codec_id(self) -> int:
        return _CODEC_IDS[self.codec]


@dataclass
class Container:
    meta: ContainerMeta
    bitmaps_blob: bytes             # zlib of stacked (s, H, W) uint8 maps
    stego_blob: bytes               # codec payload

    def _raw_maps_blob(self) -> Optional[bytes]:
        """Decompressed, length-validated bitmap blob bytes (or None)."""
        if not self.meta.has_bitmaps:
            return None
        m = self.meta
        n = m.height * m.width
        from ..utils.bits import bounded_inflate

        want = m.s * n // 8 if m.bitmaps_packed else m.s * n
        raw = bounded_inflate(self.bitmaps_blob, want, "bitmap blob")
        if m.bitmaps_packed:
            if n % 8 or len(raw) != m.s * n // 8:
                raise ValueError(
                    f"Invalid file: packed bitmap blob holds {len(raw)} bytes,"
                    f" header says {m.s}x{m.height}x{m.width} bits"
                )
        elif len(raw) != m.s * n:
            raise ValueError(
                f"Invalid file: bitmap blob holds {len(raw)} bytes, header "
                f"says {m.s}x{m.height}x{m.width}"
            )
        return raw

    def bitmaps(self) -> Optional[np.ndarray]:
        """Decompress the XOR location maps to ``(s, H, W) uint8``."""
        raw = self._raw_maps_blob()
        if raw is None:
            return None
        m = self.meta
        n = m.height * m.width
        if m.bitmaps_packed:
            from ..utils.bits import expand_bits

            return expand_bits(
                np.frombuffer(raw, dtype=np.uint8).reshape(m.s, n // 8)
            ).reshape(m.s, m.height, m.width)
        return np.frombuffer(raw, dtype=np.uint8).reshape(m.s, m.height, m.width)

    def diff(self, dtype) -> Optional[np.ndarray]:
        """The integer XOR diff ``(H, W)``: location-map plane ``k`` at bit
        ``k`` (``original = stego ^ diff``).

        For v2.1 bit-packed blobs this never materializes the ``(s, H, W)``
        planes — one cached LUT gather per plane
        (:func:`~codec_tcc_tpu_torch.utils.bits.packed_planes_to_diff`)
        instead of an unpackbits + shift/OR route."""
        raw = self._raw_maps_blob()
        if raw is None:
            return None
        m = self.meta
        dt = np.dtype(dtype)
        if m.bitmaps_packed:
            from ..utils.bits import packed_planes_to_diff

            n = m.height * m.width
            packed = np.frombuffer(raw, dtype=np.uint8).reshape(m.s, n // 8)
            return packed_planes_to_diff(packed, dt).reshape(m.height, m.width)
        maps = np.frombuffer(raw, dtype=np.uint8).reshape(m.s, -1)
        diff = np.zeros(maps.shape[1], dt)
        for k in range(m.s):
            diff |= maps[k].astype(dt) << k
        return diff.reshape(m.height, m.width)

    def restore_original(self, stego: np.ndarray) -> Optional[np.ndarray]:
        """``original = stego ^ diff`` — O(payload) for raster v2.1
        containers, full :meth:`diff` expansion otherwise.

        The raster strategies only flip bits inside each plane's stored
        window (``plane_starts[p] .. + eff_lengths[p] mod N``), so for a
        well-formed container the packed map is all-zero outside the
        window-covering bytes and restoration is one memcpy + a few LUT
        gathers (:func:`~codec_tcc_tpu_torch.utils.bits.xor_packed_windows`)
        instead of the full (s, N) expansion of mostly-zero bytes. A cheap
        byte-scan guard proves the all-zero-outside assumption first and
        falls back to the exact full form when it doesn't hold (corrupt or
        adversarial blobs), so the result is bit-identical to
        ``stego ^ self.diff(dtype)`` for EVERY input."""
        m = self.meta
        if not (m.has_bitmaps and m.bitmaps_packed
                and m.strategy in ("multi_plane", "hybrid")):
            diff = self.diff(stego.dtype)
            return None if diff is None else stego ^ diff
        raw = self._raw_maps_blob()
        if raw is None:
            return None
        from ..utils.bits import merged_byte_ranges, raster_window_spans

        n = m.height * m.width
        nb = n // 8
        packed = np.frombuffer(raw, dtype=np.uint8).reshape(m.s, nb)
        for p in range(m.s):
            # the SAME span/byte-coverage definitions the applier uses
            # (utils.bits) — guard and applier can never disagree about
            # which bytes a window covers
            covered = merged_byte_ranges(
                raster_window_spans(
                    m.plane_starts[p], m.eff_lengths[p], n
                )
            )
            # complement byte ranges must be zero, else exact fallback
            pos = 0
            outside_clean = True
            for b0, b1 in covered:
                if b0 > pos and packed[p, pos:b0].any():
                    outside_clean = False
                    break
                pos = max(pos, b1)
            if outside_clean and pos < nb and packed[p, pos:].any():
                outside_clean = False
            if not outside_clean:
                diff = self.diff(stego.dtype)
                return None if diff is None else stego ^ diff
        from ..utils.bits import xor_packed_windows

        return xor_packed_windows(
            stego.reshape(m.height, m.width), packed,
            m.plane_starts, m.eff_lengths,
        )


def compress_bitmaps(maps: np.ndarray) -> bytes:
    """zlib the stacked maps exactly like the reference
    (``zlib.compress(np.stack(bitmaps).tobytes())``, src/codec.py:888-889).

    Level 1 trades a larger blob for less host time on sparse map data. Any
    zlib stream stays format-compatible (the level is not part of the
    container format), but the level IS part of the container bytes, so the
    port keeps it to stay byte-identical with the JAX package."""
    return zlib.compress(
        np.ascontiguousarray(maps, dtype=np.uint8).tobytes(), 1
    )


def compress_bitmaps_packed(maps: np.ndarray) -> bytes:
    """v2.1 packed bitmap blob: zlib of bit-PACKED planes (``FLAG_PACKED_
    BITMAPS``). Accepts either unpacked ``(s, H, W)`` 0/1 maps (packed here
    with ``np.packbits``, MSB-first) or already-packed ``(s, H*W/8)`` bytes
    straight off the device's raster embed kernel (the maps it emits) —
    both produce the identical blob.

    8x less zlib input than :func:`compress_bitmaps`, and the device
    already ships the maps bit-packed, so the unpacked form never needs to
    exist for the container. Requires ``H*W % 8 == 0`` (writers fall back
    to the unpacked blob)."""
    maps = np.ascontiguousarray(maps, dtype=np.uint8)
    if maps.ndim == 3:
        maps = np.packbits(maps.reshape(maps.shape[0], -1), axis=1)
    return zlib.compress(maps.tobytes(), 1)


# ---------------------------------------------------------------------------
# v2 pack / parse
# ---------------------------------------------------------------------------


def pack(meta: ContainerMeta, bitmaps_blob: bytes, stego_blob: bytes) -> bytes:
    s = meta.s
    flags = (
        (FLAG_ALIGN if meta.align_across_planes else 0)
        | (FLAG_HAS_BITMAPS if meta.has_bitmaps else 0)
        | (FLAG_PACKED_BITMAPS if meta.bitmaps_packed else 0)
    )
    header = struct.pack(
        ">BBBBBBBB",
        2,
        meta.codec_id,
        STRATEGY_IDS[meta.strategy],
        s,
        meta.nbits,
        meta.bits_stored,
        _DTYPE_CODES[np.dtype(meta.dtype)],
        flags,
    )
    header += struct.pack(
        ">IIII", meta.width, meta.height, meta.start_offset, meta.seed
    )
    header += struct.pack(">Q", meta.payload_bits)
    header += struct.pack(f">{s}i", *meta.sizes)
    header += struct.pack(f">{s}B", *meta.indices)
    header += struct.pack(f">{s}I", *meta.eff_lengths)
    header += struct.pack(f">{s}I", *meta.plane_starts)
    header += struct.pack(">I", len(meta.ext)) + meta.ext
    header += struct.pack(">I", len(bitmaps_blob))
    return MAGIC + struct.pack(">I", len(header)) + header + bitmaps_blob + stego_blob


def _check_dims(width: int, height: int, s: int) -> None:
    """Reject untrusted header geometry before any size derived from it
    feeds an allocation bound.

    ``bounded_inflate`` caps (the bitmap blob's ``s*H*W`` in
    :meth:`Container._raw_maps_blob`, the PEE overflow map's ``(H*W+7)//8``
    in ``models/pee.parse_pee_container_parts``) are computed FROM these
    fields — without this guard a ~10 MB upload claiming huge dims can still
    drive multi-GB inflations. Mirrors the transport codecs' own header
    guard (``io/codecs/__init__.py`` deflate path): no image past
    ``MAX_DECODE_PIXELS`` can decode anyway, so no honest container needs a
    larger bound. ``s`` caps at 32 (nbits of any supported dtype is <= 16;
    32 leaves headroom without letting a stray byte multiply the bound 255x).
    """
    from .codecs import MAX_DECODE_PIXELS

    if not (0 < width and 0 < height and width * height <= MAX_DECODE_PIXELS):
        raise ValueError(
            f"Invalid file: header claims {width}x{height} pixels "
            f"(cap {MAX_DECODE_PIXELS})"
        )
    if s > 32:
        raise ValueError(f"Invalid file: header claims s={s} planes (cap 32)")


def parse(data: bytes) -> Container:
    if len(data) < 9 or data[:4] != MAGIC:
        raise ValueError("Invalid file: bad STGC signature")
    (header_len,) = struct.unpack_from(">I", data, 4)
    if 8 + header_len > len(data):
        raise ValueError("Invalid file: truncated STGC header")
    header = data[8 : 8 + header_len]
    body = data[8 + header_len :]
    version = header[0]
    try:
        if version == 1:
            return _parse_v1(header, body)
        if version == 2:
            return _parse_v2(header, body)
    except struct.error as exc:
        raise ValueError(f"Invalid file: malformed STGC v{version} header") from exc
    raise ValueError(f"Unsupported container version {version}")


def _parse_v2(header: bytes, body: bytes) -> Container:
    off = 0
    (version, codec_id, strategy_id, s, nbits, bits_stored, dtype_code, flags) = (
        struct.unpack_from(">BBBBBBBB", header, off)
    )
    off += 8
    width, height, start_offset, seed = struct.unpack_from(">IIII", header, off)
    off += 16
    (payload_bits,) = struct.unpack_from(">Q", header, off)
    off += 8
    sizes = struct.unpack_from(f">{s}i", header, off)
    off += 4 * s
    indices = struct.unpack_from(f">{s}B", header, off)
    off += s
    eff_lengths = struct.unpack_from(f">{s}I", header, off)
    off += 4 * s
    plane_starts = struct.unpack_from(f">{s}I", header, off)
    off += 4 * s
    (ext_len,) = struct.unpack_from(">I", header, off)
    off += 4
    ext = header[off : off + ext_len]
    off += ext_len
    (bitmaps_size,) = struct.unpack_from(">I", header, off)

    # a corrupt u64 payload_bits must not reach the decoders: their static
    # extraction lengths derive from it (a huge value aborts the process
    # inside XLA on allocation, not in Python). The loosest legitimate
    # bound is every plane of every pixel carrying payload.
    _check_dims(width, height, s)
    max_payload = 32 * int(width) * int(height)
    if payload_bits > max_payload:
        raise ValueError(
            f"Invalid file: payload_bits {payload_bits} exceeds any possible "
            f"capacity of a {width}x{height} image"
        )
    if dtype_code not in _CODE_DTYPES:
        raise ValueError(f"Invalid file: unknown dtype code {dtype_code}")

    meta = ContainerMeta(
        version=2,
        codec=_CODEC_NAMES.get(codec_id, "unknown"),
        strategy=STRATEGY_NAMES.get(strategy_id, "unknown"),
        s=s,
        nbits=nbits,
        bits_stored=bits_stored,
        dtype=_CODE_DTYPES[dtype_code],
        width=width,
        height=height,
        start_offset=start_offset,
        seed=seed,
        payload_bits=payload_bits,
        align_across_planes=bool(flags & FLAG_ALIGN),
        has_bitmaps=bool(flags & FLAG_HAS_BITMAPS),
        bitmaps_packed=bool(flags & FLAG_PACKED_BITMAPS),
        sizes=tuple(sizes),
        indices=tuple(indices),
        eff_lengths=tuple(eff_lengths),
        plane_starts=tuple(plane_starts),
        ext=ext,
    )
    return Container(meta, body[:bitmaps_size], body[bitmaps_size:])


# ---------------------------------------------------------------------------
# v1 (reference format) pack / parse — interchange compatibility
# ---------------------------------------------------------------------------


def pack_v1(
    codec: str,
    s: int,
    segments_lengths,
    segments_indices,
    bitmaps_blob: bytes,
    stego_blob: bytes,
    width: int,
    height: int,
    start_offset: int,
    align_across_planes: bool,
) -> bytes:
    """Write the reference's exact v1 layout (src/codec.py:601-670), including
    its ``>H`` field limits (struct.error beyond 65,535 — defect B5 preserved
    for fidelity; use v2 for real work)."""
    codec_id = {v: k for k, v in _V1_CODEC_NAMES.items()}.get(codec.lower())
    if codec_id is None:
        raise ValueError(
            f"codec '{codec}' has no v1 container id (v1 supports "
            f"{sorted(_V1_CODEC_NAMES.values())}); use container_version=2"
        )
    header = struct.pack(
        ">BBBBHHH", 1, codec_id, s, 1 if align_across_planes else 0,
        width, height, start_offset,
    )
    header += struct.pack(f">{s}H", *segments_lengths)
    header += struct.pack(f">{s}B", *segments_indices)
    header += struct.pack(">I", len(bitmaps_blob))
    return MAGIC + struct.pack(">I", len(header)) + header + bitmaps_blob + stego_blob


def _parse_v1(header: bytes, body: bytes) -> Container:
    base = struct.calcsize(">BBBBHHH")
    version, codec_id, s, align_flag, width, height, start_offset = struct.unpack(
        ">BBBBHHH", header[:base]
    )
    off = base
    seg_lengths = struct.unpack_from(f">{s}H", header, off)
    off += 2 * s
    seg_indices = struct.unpack_from(f">{s}B", header, off)
    off += s
    (bitmaps_size,) = struct.unpack_from(">I", header, off)
    _check_dims(width, height, s)
    meta = ContainerMeta(
        version=1,
        codec=_V1_CODEC_NAMES.get(codec_id, "unknown"),
        strategy="unknown",  # v1 does not record it (the reference hardcodes
        # the hybrid strategy in main(), src/codec.py:874)
        s=s,
        nbits=0,
        bits_stored=0,
        # placeholder only: v1 records no dtype; pipeline.decode_container
        # replaces it with the decoded transport payload's dtype
        dtype=np.dtype(np.uint16),
        width=width,
        height=height,
        start_offset=start_offset,
        seed=42,
        payload_bits=sum(seg_lengths),
        align_across_planes=bool(align_flag),
        has_bitmaps=True,
        sizes=tuple(seg_lengths),
        indices=tuple(seg_indices),
        eff_lengths=tuple(seg_lengths),
        plane_starts=tuple([0] * s),
        ext=b"",
    )
    return Container(meta, body[:bitmaps_size], body[bitmaps_size:])


# ---------------------------------------------------------------------------
# strategy extension blocks
# ---------------------------------------------------------------------------


def pack_block_ext(block_size: int) -> bytes:
    return struct.pack(">I", block_size)


def parse_block_ext(ext: bytes) -> int:
    return struct.unpack(">I", ext[:4])[0] if len(ext) >= 4 else 0


_PEE_EXT_FMT = ">IIIIQQ"  # threshold, passes, n_proc0, n_proc1, bits0, bits1


def pack_pee_ext(
    threshold: int, passes: int, n_proc0: int, n_proc1: int,
    bits0: int, bits1: int,
) -> bytes:
    return struct.pack(_PEE_EXT_FMT, threshold, passes, n_proc0, n_proc1,
                       bits0, bits1)


def parse_pee_ext(ext: bytes) -> Tuple[int, int, int, int, int, int]:
    """(threshold, passes, n_proc0, n_proc1, bits0, bits1)."""
    return struct.unpack(_PEE_EXT_FMT, ext[: struct.calcsize(_PEE_EXT_FMT)])
