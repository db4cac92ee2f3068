# Port of codec_tcc_tpu/io/codecs/__init__.py: the registry and DeflateCodec
# unchanged; png/j2k/jls/jxl are registered but not yet ported.
"""Symmetric lossless image codec registry.

One contract for every transport codec:

    encode(array: np.ndarray) -> bytes      # self-describing payload
    decode(data: bytes) -> np.ndarray       # exact inverse

``deflate`` (zlib with a tiny shape/dtype header) is the codec of the
default path and the only one ported so far. ``png``, ``j2k``, ``jls`` and
``jxl`` keep their registry names and container ids so ``names()`` and
``by_id`` answer as in the JAX package, but report themselves unavailable
(``available_names()`` stays honest) and raise ``NotImplementedError``
until their port lands (ROADMAP.md, queue 1: "other codecs").

Codec ids 1-4 keep the reference's container mapping
(``{'png':1,'j2k':2,'jls':3,'jxl':4}``, src/codec.py:616); deflate is 5.
"""

from __future__ import annotations

import abc
import struct
import zlib
from typing import Dict, List

import numpy as np

__all__ = [
    "Codec",
    "MAX_DECODE_PIXELS",
    "get",
    "by_id",
    "names",
    "available_names",
    "register",
    "decode_transfer_syntax_frame",
]

# decoded-image size cap shared by every transport codec and the container
# parser (the JAX package keeps it in io/jpegls_binding.py)
MAX_DECODE_PIXELS = 1 << 28


class Codec(abc.ABC):
    name: str = ""
    codec_id: int = 0

    @abc.abstractmethod
    def available(self) -> bool: ...

    @abc.abstractmethod
    def encode(self, image: np.ndarray) -> bytes: ...

    @abc.abstractmethod
    def decode(self, data: bytes) -> np.ndarray: ...


_REGISTRY: Dict[str, Codec] = {}


def register(codec: Codec) -> Codec:
    _REGISTRY[codec.name] = codec
    return codec


def get(name: str) -> Codec:
    try:
        codec = _REGISTRY[name.lower()]
    except KeyError:
        raise ValueError(
            f"Codec '{name}' not supported (have: {sorted(_REGISTRY)})"
        ) from None
    if not codec.available():
        raise RuntimeError(
            f"Codec '{name}' is registered but unavailable in this environment"
        )
    return codec


def by_id(codec_id: int) -> Codec:
    for codec in _REGISTRY.values():
        if codec.codec_id == codec_id:
            return codec
    raise ValueError(f"Unknown codec id {codec_id}")


def names() -> List[str]:
    return sorted(_REGISTRY)


def available_names() -> List[str]:
    return sorted(n for n, c in _REGISTRY.items() if c.available())


# ---------------------------------------------------------------------------
# deflate — the default transport codec
# ---------------------------------------------------------------------------

_DEFLATE_MAGIC = b"SDFL"
_DTYPE_CODES = {np.dtype(np.uint8): 1, np.dtype(np.uint16): 2}
_CODE_DTYPES = {1: np.uint8, 2: np.uint16}


class DeflateCodec(Codec):
    name = "deflate"
    codec_id = 5

    def available(self) -> bool:
        return True

    def encode(self, image: np.ndarray) -> bytes:
        # Z_RLE at level 1: faster than the default match strategy at the
        # same level for slightly larger output on stego pixel data. The
        # strategy is not part of the format (any zlib stream decodes), but
        # it is part of the container BYTES: keep these parameters equal to
        # the JAX package's or the containers stop being byte-identical.
        co = zlib.compressobj(1, zlib.DEFLATED, 15, 9, zlib.Z_RLE)
        if image.dtype == np.uint16:
            # byte-plane split (code 3): all low bytes, then all high bytes.
            # Interleaved lo,hi,lo,hi breaks the byte runs RLE feeds on; for
            # 12-bit medical data the high plane is near-constant.
            code = 3
            raw = (
                (image & 0xFF).astype(np.uint8).tobytes()
                + (image >> 8).astype(np.uint8).tobytes()
            )
        else:
            code = _DTYPE_CODES[np.dtype(image.dtype)]
            raw = np.ascontiguousarray(image).tobytes()
        header = _DEFLATE_MAGIC + struct.pack(">BII", code, *image.shape)
        return header + co.compress(raw) + co.flush()

    def decode(self, data: bytes) -> np.ndarray:
        if data[:4] != _DEFLATE_MAGIC:
            raise ValueError("Not a deflate codec payload")
        try:
            code, h, w = struct.unpack(">BII", data[4:13])
            # code 2 (interleaved uint16) is the older layout: still
            # written by nothing, still decoded forever (golden .stgc
            # fixtures and old containers carry it)
            dtype = np.dtype(np.uint16 if code == 3 else _CODE_DTYPES[code])
        except (struct.error, KeyError) as exc:
            raise ValueError(f"Invalid file: corrupt deflate payload ({exc})") from exc

        if not (0 < h and 0 < w and h * w <= MAX_DECODE_PIXELS):
            raise ValueError(
                f"Invalid file: deflate header claims {h}x{w} pixels "
                f"(cap {MAX_DECODE_PIXELS})"
            )
        # bounded inflate: the header fixes the exact byte count, so an
        # untrusted stream must never decompress past it (zip bomb)
        from ...utils.bits import bounded_inflate

        raw = bounded_inflate(
            data[13:], h * w * dtype.itemsize, "deflate payload"
        )
        if len(raw) != h * w * dtype.itemsize:
            raise ValueError(
                f"Invalid file: deflate payload holds {len(raw)} bytes, "
                f"header says {h}x{w} {dtype}"
            )
        if code == 3:
            planes = np.frombuffer(raw, dtype=np.uint8)
            n = h * w
            return (
                planes[:n].astype(np.uint16)
                | (planes[n:].astype(np.uint16) << 8)
            ).reshape(h, w)
        return np.frombuffer(raw, dtype=dtype).reshape(h, w).copy()


# ---------------------------------------------------------------------------
# codecs of the JAX package that are still to be ported
# ---------------------------------------------------------------------------


class NotYetPortedCodec(Codec):
    """Registry placeholder for a JAX-package codec whose port has not
    landed: it keeps the name and container id, reports itself unavailable
    and raises on use."""

    def __init__(self, name: str, codec_id: int) -> None:
        self.name = name
        self.codec_id = codec_id

    def available(self) -> bool:
        return False

    def _raise(self):
        raise NotImplementedError(
            f"codec {self.name!r} is not yet ported to codec_tcc_tpu_torch "
            f"(ROADMAP.md, queue 1: other codecs); use 'deflate'"
        )

    def encode(self, image: np.ndarray) -> bytes:
        self._raise()

    def decode(self, data: bytes) -> np.ndarray:
        self._raise()


register(DeflateCodec())
register(NotYetPortedCodec("png", 1))
register(NotYetPortedCodec("j2k", 2))
register(NotYetPortedCodec("jls", 3))
register(NotYetPortedCodec("jxl", 4))


def decode_transfer_syntax_frame(fragment: bytes, transfer_syntax: str) -> np.ndarray:
    """Decode one encapsulated DICOM pixel-data fragment (used by
    :mod:`codec_tcc_tpu_torch.io.dicom` for JPEG2000/JPEG-LS transfer
    syntaxes). Both codecs are still to be ported, so this raises."""
    from ..dicom import JPEG2000_LOSSLESS, JPEGLS_LOSSLESS

    if transfer_syntax == JPEG2000_LOSSLESS:
        return _REGISTRY["j2k"].decode(fragment)
    if transfer_syntax == JPEGLS_LOSSLESS:
        return _REGISTRY["jls"].decode(fragment)
    raise ValueError(f"Unsupported encapsulated transfer syntax {transfer_syntax}")
