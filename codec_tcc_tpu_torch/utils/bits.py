# Port of codec_tcc_tpu/utils/bits.py: the same code; only import lines and prose differ.
"""Host-side payload bit helpers.

Capability parity with the reference's ``message_to_bits``
(``src/codec.py:239-240``: 8 bits per ``ord(char)``) and the
byte re-packing inside its ``decode_message``
(``src/codec.py:779-787``), re-designed around *bytes*
payloads so arbitrary binary data round-trips exactly (the reference silently
corrupts any character with ``ord(c) > 255``).

Bit order is MSB-first within each byte, matching ``f"{ord(c):08b}"``.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "bytes_to_bits",
    "bits_to_bytes",
    "message_to_bits",
    "bits_to_message",
    "pack_bits",
    "unpack_bits",
    "expand_bits",
    "packed_planes_to_diff",
    "xor_packed_windows",
    "raster_window_spans",
    "merged_byte_ranges",
    "bounded_inflate",
]


def raster_window_spans(start: int, ln: int, n: int) -> list:
    """The <= 2 half-open BIT spans of a raster window ``[start, start+ln)
    mod n`` (second span when it wraps). THE single definition of raster
    window geometry — the windowed XOR applier
    (:func:`xor_packed_windows`), the O(payload) host embed
    (``ops.host_embed``), and ``Container.restore_original``'s
    outside-the-window zero guard all derive from it, so they can never
    disagree about which bits a window covers."""
    ln = min(int(ln), n)
    if ln <= 0:
        return []
    start = int(start) % n
    end = start + ln
    if end <= n:
        return [(start, end)]
    return [(start, n), (0, end - n)]


def merged_byte_ranges(spans) -> list:
    """Union of the BYTE ranges covering bit spans ``[(a, b), ...)`` —
    sorted, overlapping/adjacent ranges coalesced so a shared boundary byte
    appears exactly once (the windowed XOR/embed helpers must touch each
    byte once; see :func:`xor_packed_windows`). Empty input -> []."""
    if not spans:
        return []
    ranges = sorted((a // 8, (b + 7) // 8) for a, b in spans)
    merged = [ranges[0]]
    for b0, b1 in ranges[1:]:
        if b0 <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], b1))
        else:
            merged.append((b0, b1))
    return merged


def xor_packed_windows(
    image: np.ndarray,
    packed: np.ndarray,
    starts,
    lengths,
) -> np.ndarray:
    """``image XOR diff`` for RASTER-WINDOWED bit-packed plane maps — the
    O(payload) twin of ``image ^ packed_planes_to_diff(packed, dtype)``.

    The raster strategies only ever flip bits inside each plane's window
    ``[start_p, start_p + len_p) mod N`` (``ops.embed.embed``'s active
    mask), so plane ``p`` of ``packed`` is all-zero outside the bytes that
    cover its window. Reconstructing the stego therefore needs one O(N)
    memcpy of the image plus one cached-LUT gather per window span (<= 2
    spans per plane when the hybrid window wraps) — not the full (s, N)
    expansion + whole-image XOR, whose bytes are mostly zeros for payloads
    much smaller than the image.

    Requires ``N % 8 == 0`` (the packed-maps serving gate). Bit-exact with
    the full expansion for any plan the raster embed kernels can produce,
    including overlapping and wrapping windows (property-tested)."""
    dt = image.dtype
    out = image.copy()
    flat = out.reshape(-1)
    n = flat.size
    if n % 8:
        raise ValueError("xor_packed_windows needs N % 8 == 0")
    s = packed.shape[0]
    for p in range(s):
        spans = raster_window_spans(starts[p], lengths[p], n)
        if not spans:
            continue
        # merge the spans' BYTE ranges before applying: a byte holds the
        # packed bits of every span that touches it, so one LUT XOR of that
        # byte applies them all — applying it once per touching span would
        # XOR twice and cancel (reachable when a wrapping window sits
        # within 7 bits of full plane capacity with an unaligned start)
        merged = merged_byte_ranges(spans)
        lut = _plane_lut(p, dt)
        for b0, b1 in merged:
            g = lut[packed[p, b0:b1]].reshape(-1)
            seg = flat[8 * b0 : 8 * b1]
            np.bitwise_xor(seg, g, out=seg)
    return out


def bounded_inflate(blob: bytes, want: int, what: str) -> bytes:
    """zlib-inflate an UNTRUSTED blob whose exact decompressed size the
    surrounding format's header commits to.

    Plain ``zlib.decompress`` inflates fully before any caller-side length
    check, so a crafted container could expand a few KB into GBs (zip bomb).
    Inflating with ``max_length = want + 1`` bounds the allocation: one extra
    byte distinguishes over-long streams, and a stream that ends early
    (``eof`` unset) is rejected as truncated. Raises ``ValueError`` with an
    ``Invalid file:`` message (the shared corrupt-input contract) on any
    mismatch; the caller still performs its own exact-length validation."""
    import zlib

    try:
        dobj = zlib.decompressobj()
        raw = dobj.decompress(blob, max(want, 0) + 1)
    except zlib.error as exc:
        raise ValueError(f"Invalid file: corrupt {what} ({exc})") from exc
    if dobj.unconsumed_tail or not dobj.eof:
        raise ValueError(
            f"Invalid file: {what} inflates past or short of the "
            f"{want} bytes its header commits to"
        )
    return raw


def bytes_to_bits(payload: bytes) -> np.ndarray:
    """``bytes`` -> uint8 array of 0/1 bits, MSB-first per byte."""
    if len(payload) == 0:
        return np.zeros((0,), dtype=np.uint8)
    arr = np.frombuffer(payload, dtype=np.uint8)
    return np.unpackbits(arr)  # MSB-first, matches the reference bit order


def bits_to_bytes(bits: np.ndarray) -> bytes:
    """uint8 0/1 bit array -> bytes; trailing partial bytes are dropped,
    mirroring the reference's ``if len(byte_bits) == 8`` guard
    (``src/codec.py:782``)."""
    bits = np.asarray(bits, dtype=np.uint8)
    n_full = (bits.size // 8) * 8
    if n_full == 0:
        return b""
    return np.packbits(bits[:n_full]).tobytes()


def message_to_bits(message: str) -> np.ndarray:
    """UTF-8 encode then bit-expand.

    For pure-ASCII messages this is bit-identical to the reference's
    ``''.join(f"{ord(c):08b}")`` (``src/codec.py:240``); for non-ASCII it is a
    correct generalization (the reference emits >8-bit chunks and breaks).
    """
    return bytes_to_bits(message.encode("utf-8"))


def bits_to_message(bits: np.ndarray) -> str:
    """Inverse of :func:`message_to_bits`; decodes UTF-8 with replacement,
    matching ``bytes(message_bytes).decode('utf-8', errors='replace')``
    (``src/codec.py:786``)."""
    return bits_to_bytes(bits).decode("utf-8", errors="replace")


def pack_bits(bits: np.ndarray) -> bytes:
    """Dense-pack a 0/1 array into bytes (MSB-first), padding with zeros."""
    return np.packbits(np.asarray(bits, dtype=np.uint8)).tobytes()


def unpack_bits(data: bytes, n_bits: int) -> np.ndarray:
    """Inverse of :func:`pack_bits`, truncated to ``n_bits``."""
    arr = np.frombuffer(data, dtype=np.uint8)
    return np.unpackbits(arr)[:n_bits]


_PLANE_LUTS: dict = {}


def _plane_lut(k: int, dt: np.dtype) -> np.ndarray:
    """(256, 8) table: byte value -> its 8 MSB-first bits, each shifted to
    plane position ``k`` in dtype ``dt``. Cached per (plane, dtype)."""
    key = (k, dt.str)
    lut = _PLANE_LUTS.get(key)
    if lut is None:
        bits = ((np.arange(256)[:, None] >> (7 - np.arange(8))[None, :]) & 1)
        lut = (bits << k).astype(dt)
        _PLANE_LUTS[key] = lut
    return lut


_PAIR_LUTS: dict = {}


def _pair_lut(k: int, dt: np.dtype) -> np.ndarray:
    """(65536, 8) table: the byte pair ``(plane k << 8) | plane k+1`` -> 8
    MSB-first pixels with bits ``k`` and ``k+1`` both set. One gather covers
    two planes (s/2 passes over the output instead of s); the table is
    256x larger, so the win is bounded by cache behaviour."""
    key = (k, dt.str)
    lut = _PAIR_LUTS.get(key)
    if lut is None:
        lut = np.ascontiguousarray(
            (_plane_lut(k, dt)[:, None, :] | _plane_lut(k + 1, dt)[None, :, :])
            .reshape(65536, 8)
        )
        _PAIR_LUTS[key] = lut
    return lut


def expand_bits(packed: np.ndarray) -> np.ndarray:
    """``(..., nb) uint8`` packed bytes -> ``(..., nb*8) uint8`` 0/1 bits,
    MSB-first: same output as ``np.unpackbits(..., axis=-1)`` via one cached
    LUT gather."""
    packed = np.asarray(packed)
    if packed.dtype != np.uint8:
        raise ValueError(f"packed bits must be uint8, got {packed.dtype}")
    return _plane_lut(0, np.dtype(np.uint8))[packed].reshape(
        *packed.shape[:-1], packed.shape[-1] * 8
    )


def packed_planes_to_diff(packed: np.ndarray, dtype) -> np.ndarray:
    """``(..., s, n//8)`` MSB-first bit-packed plane maps -> ``(..., n)``
    integer diff where plane ``k`` contributes bit ``k``.

    One cached 256->8 LUT gather per plane instead of ``np.unpackbits`` +
    per-plane ``astype``/shift/OR."""
    packed = np.asarray(packed)
    if packed.dtype != np.uint8:
        raise ValueError(f"packed plane maps must be uint8, got {packed.dtype}")
    *lead, s, nb = packed.shape
    dt = np.dtype(dtype)
    if s == 0:
        return np.zeros((*lead, nb * 8), dt)
    if s > 8 * dt.itemsize:
        raise ValueError(f"{s} planes do not fit a {dt} diff")
    diff = None
    k = 0
    while k + 1 < s:
        # two planes per gather via the 16-bit pair table
        idx = packed[..., k, :].astype(np.uint16)
        idx <<= 8
        idx |= packed[..., k + 1, :]
        g = _pair_lut(k, dt)[idx]
        diff = g if diff is None else np.bitwise_or(diff, g, out=diff)
        k += 2
    if k < s:
        g = _plane_lut(k, dt)[packed[..., k, :]]
        diff = g if diff is None else np.bitwise_or(diff, g, out=diff)
    return diff.reshape(*lead, nb * 8)
