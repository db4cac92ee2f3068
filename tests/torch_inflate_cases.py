"""Deflate payloads (the codec's SDFL header and a zlib stream) for the
inflate kernels (``codec_tcc_tpu_torch/ops/inflate.py``,
``csrc/inflate.cu``), shared by the CPU tests of the plain version and the
host-built routines and by the GPU tests and ``chip_smoke.py``.

``DEVICE`` payloads are what the kernels must decode to zlib's bytes:
the deflate codec's streams of the corpus of ``torch_deflate_cases.py``
and of the benchmark's phantoms, a level-0 stream (stored blocks only),
one block, uint8, a stream of fixed-code blocks of ``Z_RLE`` tokens
(zlib's ``Z_FIXED`` strategy keeps its default matcher, whose distances
go past 1; this one is the plain encoder's with every block sent with the
fixed code), which the chain decodes itself, zlib at ``memLevel`` 1
(blocks of 128 symbols: more blocks than the emit's grid, which the chain
emits itself), and stored blocks full of copies of a dynamic header
before a real stream (more candidates than the measure takes, so the
chain decodes the real blocks itself). ``HOST`` payloads are what the host
codec must decode, or refuse, as before: zlib's default strategy and its
``Z_FIXED`` (distances over 1), Huffman codes that zlib takes incomplete
(no distance code, a single 1-bit distance code, a single 1-bit end
code), the old interleaved code 2, a truncated stream, a flipped Adler-32
byte, streams one byte longer or shorter than their header, and an
incomplete code that zlib refuses.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

import torch_deflate_cases as dc


def sdfl(image: np.ndarray, level: int = 1, strategy: int = zlib.Z_RLE,
         mem_level: int = 9, code: int = 0, header_shape=None) -> bytes:
    """The deflate codec's payload of ``image`` with other zlib settings
    (code 3 / 1 by dtype; ``code`` 2 writes the old interleaved bytes)."""
    if image.dtype == np.uint16 and code != 2:
        raw = (image & 0xFF).astype(np.uint8).tobytes() + (
            image >> 8).astype(np.uint8).tobytes()
        code = 3
    else:
        raw = np.ascontiguousarray(image).tobytes()
        code = code or 1
    co = zlib.compressobj(level, zlib.DEFLATED, 15, mem_level, strategy)
    shape = header_shape or image.shape
    return b"SDFL" + struct.pack(">BII", code, *shape) + co.compress(raw) + \
        co.flush()


def fixed_code(image: np.ndarray) -> bytes:
    """The codec's payload of ``image`` with every block sent with the fixed
    code: the plain Z_RLE encoder with the choice forced to static."""
    from codec_tcc_tpu_torch.ops import deflate_rle as d

    real = d.block_code
    d.block_code = lambda *a: real(*a)._replace(kind=d.STATIC)
    try:
        return d.encode_plain(image)
    finally:
        d.block_code = real


def _codec(image: np.ndarray) -> bytes:
    from codec_tcc_tpu_torch.io.codecs import get

    return get("deflate").encode(image)


def phantom_payload(h: int, w: int, seed: int) -> bytes:
    return _codec(dc.phantom(h, w, seed=seed))


def _u8_phantom() -> np.ndarray:
    return (dc.phantom(200, 300, seed=11) >> 4).astype(np.uint8)


class _BitWriter:
    """LSB-first bits, as deflate packs them; Huffman codes go in MSB
    first."""

    def __init__(self):
        self.acc, self.n = 0, 0

    def put(self, value: int, nbits: int) -> None:
        self.acc |= (value & ((1 << nbits) - 1)) << self.n
        self.n += nbits

    def code(self, code: int, length: int) -> None:
        self.put(int(format(code, f"0{length}b")[::-1], 2), length)

    def align(self) -> None:
        self.n = (self.n + 7) & ~7

    def bytes(self) -> bytes:
        return self.acc.to_bytes((self.n + 7) // 8, "little")


def _canonical(lens: dict) -> dict:
    """symbol -> (code, length) of the canonical code of ``lens``."""
    out, code, prev = {}, 0, 0
    for sym, ln in sorted(lens.items(), key=lambda kv: (kv[1], kv[0])):
        code <<= ln - prev
        out[sym] = (code, ln)
        code, prev = code + 1, ln
    return out


_CL_ORDER = (16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1,
             15)


def _dynamic_block(bw: _BitWriter, final: int, lit: dict, dist: dict,
                   tokens) -> None:
    """One dynamic block with the given code lengths (symbol -> length,
    any code zlib's inflate takes) and tokens: ``("lit", byte)``,
    ``("match", length symbol, distance symbol)`` (no extra bits), or
    ``("end",)``."""
    nlen = max(max(lit) + 1, 257)
    ndist = max(max(dist) + 1, 1) if dist else 1
    seq = [lit.get(i, 0) for i in range(nlen)] + \
        [dist.get(i, 0) for i in range(ndist)]
    runs, i = [], 0          # (code length symbol, extra value, extra bits)
    while i < len(seq):
        j = i
        while j < len(seq) and seq[j] == seq[i] and j - i < 138:
            j += 1
        if seq[i] == 0 and j - i >= 11:
            runs.append((18, j - i - 11, 7))
        elif seq[i] == 0 and j - i >= 3:
            runs.append((17, j - i - 3, 3))
        else:
            j = i + 1
            runs.append((seq[i], 0, 0))
        i = j
    used = sorted({r[0] for r in runs})
    # a complete code length code over the symbols used
    cl = {}
    depth = 1
    while (1 << depth) < len(used):
        depth += 1
    spare = (1 << depth) - len(used)
    for k, sym in enumerate(used):
        cl[sym] = depth - 1 if k < spare else depth
    cl_codes = _canonical(cl)
    ncl = max(_CL_ORDER.index(sym) for sym in cl) + 1
    bw.put(final, 1)
    bw.put(2, 2)
    bw.put(nlen - 257, 5)
    bw.put(ndist - 1, 5)
    bw.put(ncl - 4, 4)
    for sym in _CL_ORDER[:ncl]:
        bw.put(cl.get(sym, 0), 3)
    for sym, extra, nbits in runs:
        bw.code(*cl_codes[sym])
        bw.put(extra, nbits)
    lit_codes, dist_codes = _canonical(lit), _canonical(dist)
    for tok in tokens:
        if tok[0] == "lit":
            bw.code(*lit_codes[tok[1]])
        elif tok[0] == "match":
            bw.code(*lit_codes[tok[1]])
            bw.code(*dist_codes[tok[2]])
    bw.code(*lit_codes[256])


def _zlib_payload(bw: _BitWriter, raw: bytes) -> bytes:
    """The codec's code-1 payload of ``raw`` as a (1, n) uint8 image, with
    the deflate data in ``bw``."""
    stream = b"\x78\x01" + bw.bytes() + zlib.adler32(raw).to_bytes(4, "big")
    return b"SDFL" + struct.pack(">BII", 1, 1, len(raw)) + stream


def no_distance_code() -> bytes:
    """Literals only, in a dynamic block with no distance code."""
    raw = b"ABBA" * 25
    bw = _BitWriter()
    _dynamic_block(bw, 1, {65: 2, 66: 2, 256: 2, 257: 2}, {},
                   [("lit", b) for b in raw])
    return _zlib_payload(bw, raw)


def one_distance_code() -> bytes:
    """Distance-1 matches through a single 1-bit distance code."""
    bw = _BitWriter()
    _dynamic_block(bw, 1, {65: 2, 256: 2, 257: 2, 258: 2}, {0: 1},
                   [("lit", 65)] + [("match", 257, 0), ("match", 258, 0)] * 9)
    return _zlib_payload(bw, b"A" * (1 + 7 * 9))


def one_end_code() -> bytes:
    """An empty dynamic block whose literal/length code is the end code
    alone (1 bit), then the bytes in a stored block."""
    raw = bytes(range(200))
    bw = _BitWriter()
    _dynamic_block(bw, 0, {256: 1}, {0: 1, 1: 1}, [])
    bw.put(1, 1)
    bw.put(0, 2)
    bw.align()
    bw.put(len(raw), 16)
    bw.put(~len(raw) & 0xFFFF, 16)
    for b in raw:
        bw.put(b, 8)
    return _zlib_payload(bw, raw)


def two_short_codes() -> bytes:
    """A literal/length code of two 2-bit codes: incomplete, and not a
    code zlib takes."""
    raw = b"A" * 10
    bw = _BitWriter()
    _dynamic_block(bw, 1, {65: 2, 256: 2}, {0: 1, 1: 1},
                   [("lit", 65)] * 10)
    return _zlib_payload(bw, raw)


def false_candidates(h: int = 256, w: int = 256) -> bytes:
    """Stored blocks full of byte-aligned copies of a phantom stream's
    first dynamic header, then the codec's raw deflate stream of the rest
    of the image's bytes: far more candidates than the measure takes."""
    from codec_tcc_tpu_torch.ops import inflate as inf

    import torch_inflate_plain as plain

    image = dc.phantom(h, w, seed=5)
    raw = (image & 0xFF).astype(np.uint8).tobytes() + (
        image >> 8).astype(np.uint8).tobytes()
    stream = _codec(image)[inf.SDFL_HEADER:]
    r = plain._Bits(stream)
    first = next(p for p in range(16, 8 * len(stream))
                 if plain.dynamic_header(r, p) is not None)
    data = plain.dynamic_header(r, first).data_bit
    copy = stream[first // 8:(data + 7) // 8 + 1]
    fake = (copy * (len(raw) // 2 // len(copy)))[:len(raw) // 2]
    body = bytearray(b"\x78\x01")
    for k in range(0, len(fake), 65535):
        piece = fake[k:k + 65535]
        body += bytes([0]) + struct.pack("<HH", len(piece),
                                         ~len(piece) & 0xFFFF) + piece
    co = zlib.compressobj(1, zlib.DEFLATED, -15, 9, zlib.Z_RLE)
    body += co.compress(raw[len(fake):]) + co.flush()
    full = fake + raw[len(fake):]
    body += zlib.adler32(full).to_bytes(4, "big")
    return b"SDFL" + struct.pack(">BII", 3, h, w) + bytes(body)


_DEVICE = {
    **{f"corpus_{name}": (lambda name=name: _codec(dc.case(name)))
       for name in dc.NAMES},
    "u8_200x300": lambda: _codec(_u8_phantom()),
    "level0_256x256": lambda: sdfl(dc.phantom(256, 256), level=0),
    "one_block_37x53": lambda: sdfl(dc.case("odd_u16_37x53")),
    "fixed_code_256x256": lambda: fixed_code(dc.phantom(256, 256)),
    "fixed_code_u8": lambda: fixed_code(_u8_phantom()),
    "memlevel1_256x256": lambda: sdfl(dc.phantom(256, 256), mem_level=1),
    "false_candidates_256x256": false_candidates,
}

_HOST = {
    "level6_default": lambda: sdfl(dc.phantom(256, 256), 6,
                                   zlib.Z_DEFAULT_STRATEGY, 8),
    "zlib_z_fixed": lambda: sdfl(dc.phantom(256, 256), 1, zlib.Z_FIXED),
    "no_distance_code": no_distance_code,
    "one_distance_code": one_distance_code,
    "one_end_code": one_end_code,
    "code2": lambda: sdfl(dc.phantom(64, 64), code=2),
    "truncated": lambda: _codec(dc.phantom(256, 256))[:-40],
    "adler_flipped": lambda: _flip_last(_codec(dc.phantom(256, 256))),
    "one_past": lambda: sdfl(_u8_phantom().reshape(1, -1),
                             header_shape=(1, 200 * 300 - 1)),
    "one_short": lambda: sdfl(_u8_phantom().reshape(1, -1)[:, 1:],
                              header_shape=(1, 200 * 300)),
    "two_short_codes": two_short_codes,
}


def _flip_last(blob: bytes) -> bytes:
    return blob[:-1] + bytes([blob[-1] ^ 0x01])


DEVICE = tuple(_DEVICE)
HOST = tuple(_HOST)
PHANTOM_SHAPES = ((512, 512), (2048, 2048))
PHANTOM_SEEDS = (7, 8, 9)


def payload(name: str) -> bytes:
    return (_DEVICE.get(name) or _HOST[name])()
