"""The benchmark's own reader of the port's output formats.

Written from the format descriptions (STGC v2/v2.1, the ``deflate``
transport payload, the PEE extension block, STGV), with ``struct`` and
``zlib`` only: it imports nothing of the program, so a container the
program writes is judged by code the program does not share.

    b"STGC" | >I header_len | header_v2 | bitmaps_blob | stego_blob
    header_v2 = >BBBBBBBB version, codec_id, strategy, s, nbits,
                bits_stored, dtype_code, flags
                >IIII width, height, start_offset, seed   >Q payload_bits
                {s}i sizes  {s}B indices  {s}I eff_lengths  {s}I plane_starts
                >I ext_len | ext   >I bitmaps_blob_size
    deflate payload = b"SDFL" | >BII code, h, w | zlib(raw); code 3 is
                uint16 as all low bytes, then all high bytes
    STGV = b"STGV" | >IIQIB version, depth, total_bits, s, strategy |
           {depth}Q sizes | one STGC container per slice
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

CODEC_IDS = {"png": 1, "j2k": 2, "jls": 3, "jxl": 4, "deflate": 5}
STRATEGY_IDS = {"multi_plane": 1, "block_adaptive": 2, "hybrid": 3, "pee": 4}
DTYPE_CODES = {"uint8": 1, "uint16": 2}
FLAG_ALIGN, FLAG_HAS_BITMAPS, FLAG_PACKED = 1, 2, 4
PEE_EXT = ">IIIIQQ"     # T, passes, nproc0, nproc1, bits0, bits1


def parse_stgc(data: bytes) -> dict:
    """Every header field of an STGC v2 container, with its two blobs."""
    if data[:4] != b"STGC":
        raise ValueError("not an STGC container")
    (hlen,) = struct.unpack_from(">I", data, 4)
    head = data[8:8 + hlen]
    keys = ("version", "codec_id", "strategy_id", "s", "nbits",
            "bits_stored", "dtype_code", "flags")
    out = dict(zip(keys, struct.unpack_from(">8B", head, 0)))
    if out["version"] != 2:
        raise ValueError(f"STGC version {out['version']}, not 2")
    out.update(zip(("width", "height", "start_offset", "seed"),
                   struct.unpack_from(">4I", head, 8)))
    (out["payload_bits"],) = struct.unpack_from(">Q", head, 24)
    s, off = out["s"], 32
    for key, fmt, size in (("sizes", "i", 4), ("indices", "B", 1),
                           ("eff_lengths", "I", 4), ("plane_starts", "I", 4)):
        out[key] = tuple(struct.unpack_from(f">{s}{fmt}", head, off))
        off += size * s
    (ext_len,) = struct.unpack_from(">I", head, off)
    out["ext"] = bytes(head[off + 4:off + 4 + ext_len])
    (maps_len,) = struct.unpack_from(">I", head, off + 4 + ext_len)
    body = data[8 + hlen:]
    out["bitmaps_blob"] = body[:maps_len]
    out["stego_blob"] = body[maps_len:]
    return out


def inflate_stego(blob: bytes) -> np.ndarray:
    """The ``deflate`` transport payload as its ``(h, w)`` image."""
    if blob[:4] != b"SDFL":
        raise ValueError("not a deflate transport payload")
    code, h, w = struct.unpack_from(">BII", blob, 4)
    raw = zlib.decompress(blob[13:])
    if code == 3:
        planes = np.frombuffer(raw, np.uint8)
        lo, hi = planes[:h * w].astype(np.uint16), planes[h * w:]
        return (lo | (hi.astype(np.uint16) << 8)).reshape(h, w)
    dtype = {1: np.uint8, 2: np.uint16}[code]
    return np.frombuffer(raw, dtype).reshape(h, w).copy()


def inflate_maps(blob: bytes) -> np.ndarray:
    """The bitmaps blob's bytes (packed planes, or the packed overflow
    map) as uint8."""
    return np.frombuffer(zlib.decompress(blob), np.uint8)


def pee_ext(ext: bytes) -> tuple:
    return struct.unpack(PEE_EXT, ext[:struct.calcsize(PEE_EXT)])


def parse_stgv(data: bytes) -> dict:
    """The STGV header and its slices' containers."""
    if data[:4] != b"STGV":
        raise ValueError("not an STGV volume")
    version, depth, total_bits, s, strategy = struct.unpack_from(
        ">IIQIB", data, 4)
    off = 4 + struct.calcsize(">IIQIB")
    sizes = struct.unpack_from(f">{depth}Q", data, off)
    off += 8 * depth
    slices = []
    for size in sizes:
        slices.append(data[off:off + size])
        off += size
    return {"version": version, "depth": depth, "total_bits": total_bits,
            "s": s, "strategy_id": strategy, "slices": slices}
