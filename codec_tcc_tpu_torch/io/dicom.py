# Port of codec_tcc_tpu/io/dicom.py: the same code; only import lines and prose differ.
"""Self-contained DICOM reader/writer (no pydicom dependency).

The reference delegates all DICOM I/O to pydicom
(``src/codec.py:19-106,211-213``). pydicom is not available in
this environment, so the framework ships its own implementation of the subset
of DICOM PS3.10/PS3.5 that the workload needs:

* reading Part-10 files in Implicit VR Little Endian (``1.2.840.10008.1.2``),
  Explicit VR Little Endian (``1.2.840.10008.1.2.1``) and Deflated Explicit VR
  Little Endian (``1.2.840.10008.1.2.1.99``) — this covers both bundled test
  images (``images/torax.dcm`` is Implicit VR LE, ``images/pe.dcm`` is
  Explicit VR LE) and the deflated files the reference's ``'png'`` codec path
  produces (``src/codec.py:151-162``);
* encapsulated transfer syntaxes (JPEG 2000 / JPEG-LS lossless) are parsed into
  their fragment list so the codec registry can decode them;
* writing valid Secondary Capture files, mirroring the semantics of the
  reference's ``create_dicom`` (``src/codec.py:23-106``): computed
  ``BitsStored = ceil(log2(max+1))``, MONOCHROME2, Window/Level, raw
  ``PixelData``; plus a deflated variant.

Sequences (SQ) with defined and undefined lengths are parsed recursively so
arbitrary real-world files don't derail the element scan.
"""

from __future__ import annotations

import os
import struct
import zlib
from dataclasses import dataclass, field
from datetime import datetime
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# Transfer syntaxes
# ---------------------------------------------------------------------------

IMPLICIT_VR_LE = "1.2.840.10008.1.2"
EXPLICIT_VR_LE = "1.2.840.10008.1.2.1"
DEFLATED_EXPLICIT_VR_LE = "1.2.840.10008.1.2.1.99"
JPEG2000_LOSSLESS = "1.2.840.10008.1.2.4.90"
JPEGLS_LOSSLESS = "1.2.840.10008.1.2.4.80"

ENCAPSULATED_SYNTAXES = {JPEG2000_LOSSLESS, JPEGLS_LOSSLESS}

SECONDARY_CAPTURE_SOP_CLASS = "1.2.840.10008.5.1.4.1.1.7"
_IMPLEMENTATION_CLASS_UID = "1.2.826.0.1.3680043.8.498.1"  # generic root
_UID_ROOT = "1.2.826.0.1.3680043.8.498."

# VRs whose explicit encoding uses a 4-byte length preceded by 2 reserved bytes
_LONG_VRS = {
    "OB", "OW", "OF", "OD", "OL", "OV", "SQ", "UC", "UR", "UT", "UN", "SV", "UV",
}

# Minimal implicit-VR dictionary: the tags this workload reads/writes.
_TAG_VR: Dict[Tuple[int, int], str] = {
    (0x0002, 0x0000): "UL", (0x0002, 0x0001): "OB", (0x0002, 0x0002): "UI",
    (0x0002, 0x0003): "UI", (0x0002, 0x0010): "UI", (0x0002, 0x0012): "UI",
    (0x0002, 0x0013): "SH",
    (0x0008, 0x0008): "CS", (0x0008, 0x0016): "UI", (0x0008, 0x0018): "UI",
    (0x0008, 0x0020): "DA", (0x0008, 0x0021): "DA", (0x0008, 0x0023): "DA",
    (0x0008, 0x0030): "TM", (0x0008, 0x0033): "TM", (0x0008, 0x0060): "CS",
    (0x0008, 0x0064): "CS",
    (0x0010, 0x0010): "PN", (0x0010, 0x0020): "LO",
    (0x0020, 0x000D): "UI", (0x0020, 0x000E): "UI", (0x0020, 0x0011): "IS",
    (0x0020, 0x0013): "IS",
    (0x0028, 0x0002): "US", (0x0028, 0x0004): "CS", (0x0028, 0x0008): "IS",
    (0x0028, 0x0010): "US", (0x0028, 0x0011): "US", (0x0028, 0x0100): "US",
    (0x0028, 0x0101): "US", (0x0028, 0x0102): "US", (0x0028, 0x0103): "US",
    (0x0028, 0x1050): "DS", (0x0028, 0x1051): "DS",
    (0x7FE0, 0x0010): "OW",
}

_TEXT_VRS = {
    "AE", "AS", "CS", "DA", "DS", "DT", "IS", "LO", "LT", "PN", "SH", "ST",
    "TM", "UC", "UI", "UR", "UT",
}


def generate_uid(counter: List[int] = [0]) -> str:
    """Generate a unique UID under a generic org root (replaces
    ``pydicom.uid.generate_uid`` used at ``src/codec.py:50,63-64``)."""
    counter[0] += 1
    stamp = datetime.now().strftime("%Y%m%d%H%M%S%f")
    suffix = f"{stamp}{os.getpid() % 100000}{counter[0]}"
    uid = _UID_ROOT + suffix
    return uid[:64]


# ---------------------------------------------------------------------------
# Data model
# ---------------------------------------------------------------------------


@dataclass
class DataElement:
    tag: Tuple[int, int]
    vr: str
    value: Any  # bytes for binary VRs, str for text, list[Dataset] for SQ

    def text(self) -> str:
        if isinstance(self.value, bytes):
            return self.value.decode("ascii", errors="replace").rstrip("\x00 ")
        return str(self.value)


@dataclass
class Dataset:
    """An ordered tag -> DataElement mapping with typed convenience accessors."""

    elements: Dict[Tuple[int, int], DataElement] = field(default_factory=dict)
    transfer_syntax: str = EXPLICIT_VR_LE
    # For encapsulated pixel data: list of fragment byte strings
    pixel_fragments: Optional[List[bytes]] = None

    def __contains__(self, tag: Tuple[int, int]) -> bool:
        return tag in self.elements

    def get(self, tag: Tuple[int, int], default: Any = None) -> Any:
        el = self.elements.get(tag)
        return el.value if el is not None else default

    def get_int(self, tag: Tuple[int, int], default: Optional[int] = None) -> Optional[int]:
        el = self.elements.get(tag)
        if el is None:
            return default
        v = el.value
        if isinstance(v, int):
            return v
        if isinstance(v, bytes):
            if el.vr == "US" and len(v) >= 2:
                return struct.unpack("<H", v[:2])[0]
            if el.vr == "UL" and len(v) >= 4:
                return struct.unpack("<I", v[:4])[0]
            if el.vr == "SS" and len(v) >= 2:
                return struct.unpack("<h", v[:2])[0]
            v = v.decode("ascii", errors="replace")
        s = str(v).strip().strip("\x00")
        return int(s) if s else default

    def get_str(self, tag: Tuple[int, int], default: str = "") -> str:
        el = self.elements.get(tag)
        if el is None:
            return default
        if isinstance(el.value, bytes):
            return el.value.decode("ascii", errors="replace").rstrip("\x00 ").strip()
        return str(el.value).strip()

    # -- imaging attributes -------------------------------------------------

    @property
    def rows(self) -> int:
        return self.get_int((0x0028, 0x0010), 0)

    @property
    def columns(self) -> int:
        return self.get_int((0x0028, 0x0011), 0)

    @property
    def bits_allocated(self) -> int:
        return self.get_int((0x0028, 0x0100), 8)

    @property
    def bits_stored(self) -> int:
        return self.get_int((0x0028, 0x0101), self.bits_allocated)

    @property
    def high_bit(self) -> int:
        return self.get_int((0x0028, 0x0102), self.bits_stored - 1)

    @property
    def pixel_representation(self) -> int:
        return self.get_int((0x0028, 0x0103), 0)

    @property
    def samples_per_pixel(self) -> int:
        return self.get_int((0x0028, 0x0002), 1)

    @property
    def number_of_frames(self) -> int:
        return self.get_int((0x0028, 0x0008), 1) or 1

    @property
    def photometric_interpretation(self) -> str:
        return self.get_str((0x0028, 0x0004), "MONOCHROME2")

    @property
    def modality(self) -> str:
        return self.get_str((0x0008, 0x0060), "OT")

    @property
    def pixel_array(self) -> np.ndarray:
        """Decode PixelData into a numpy array (native transfer syntaxes;
        encapsulated syntaxes are decoded through the codec registry)."""
        if self.transfer_syntax in ENCAPSULATED_SYNTAXES:
            return self._decode_encapsulated()
        raw = self.get((0x7FE0, 0x0010))
        if raw is None:
            raise ValueError("Dataset has no PixelData (7FE0,0010)")
        if self.bits_allocated == 8:
            dtype = np.int8 if self.pixel_representation else np.uint8
        elif self.bits_allocated == 16:
            dtype = np.int16 if self.pixel_representation else np.uint16
        else:
            raise ValueError(f"Unsupported BitsAllocated={self.bits_allocated}")
        n = self.rows * self.columns * self.samples_per_pixel * self.number_of_frames
        arr = np.frombuffer(raw, dtype=dtype)[:n]
        if self.number_of_frames > 1:
            return arr.reshape(self.number_of_frames, self.rows, self.columns)
        return arr.reshape(self.rows, self.columns)

    def _decode_encapsulated(self) -> np.ndarray:
        if not self.pixel_fragments:
            raise ValueError("Encapsulated transfer syntax but no pixel fragments")
        from .codecs import decode_transfer_syntax_frame

        frames = [
            decode_transfer_syntax_frame(frag, self.transfer_syntax)
            for frag in self.pixel_fragments
        ]
        if len(frames) == 1:
            return frames[0]
        return np.stack(frames, axis=0)


# ---------------------------------------------------------------------------
# Reader
# ---------------------------------------------------------------------------


class _Reader:
    def __init__(self, data: bytes, offset: int = 0):
        self.data = data
        self.pos = offset

    def remaining(self) -> int:
        return len(self.data) - self.pos

    def read(self, n: int) -> bytes:
        b = self.data[self.pos : self.pos + n]
        self.pos += n
        return b

    def u16(self) -> int:
        v = struct.unpack_from("<H", self.data, self.pos)[0]
        self.pos += 2
        return v

    def u32(self) -> int:
        v = struct.unpack_from("<I", self.data, self.pos)[0]
        self.pos += 4
        return v


def _read_element_header(r: _Reader, explicit: bool) -> Tuple[Tuple[int, int], str, int]:
    group = r.u16()
    elem = r.u16()
    tag = (group, elem)
    if tag in ((0xFFFE, 0xE000), (0xFFFE, 0xE00D), (0xFFFE, 0xE0DD)):
        # Item / delimiters have no VR in either encoding
        length = r.u32()
        return tag, "", length
    if explicit:
        vr = r.read(2).decode("ascii", errors="replace")
        if vr in _LONG_VRS:
            r.read(2)  # reserved
            length = r.u32()
        else:
            length = r.u16()
    else:
        vr = _TAG_VR.get(tag, "UN")
        length = r.u32()
    return tag, vr, length


def _parse_value(vr: str, raw: bytes) -> Any:
    if vr == "US":
        return struct.unpack("<H", raw[:2])[0] if len(raw) >= 2 else None
    if vr == "UL":
        return struct.unpack("<I", raw[:4])[0] if len(raw) >= 4 else None
    if vr == "SS":
        return struct.unpack("<h", raw[:2])[0] if len(raw) >= 2 else None
    if vr == "SL":
        return struct.unpack("<i", raw[:4])[0] if len(raw) >= 4 else None
    if vr == "FL":
        return struct.unpack("<f", raw[:4])[0] if len(raw) >= 4 else None
    if vr == "FD":
        return struct.unpack("<d", raw[:8])[0] if len(raw) >= 8 else None
    if vr in _TEXT_VRS:
        return raw.decode("ascii", errors="replace").rstrip("\x00 ")
    return raw  # binary VRs (OB/OW/UN/...) stay as bytes


def _skip_or_parse_sequence(r: _Reader, explicit: bool, length: int) -> List[Dataset]:
    """Parse an SQ value (defined or undefined length) into item datasets."""
    items: List[Dataset] = []
    end = r.pos + length if length != 0xFFFFFFFF else None
    while True:
        if end is not None and r.pos >= end:
            break
        if r.remaining() < 8:
            break
        tag, _, ilen = _read_element_header(r, explicit)
        if tag == (0xFFFE, 0xE0DD):  # sequence delimiter
            break
        if tag != (0xFFFE, 0xE000):
            raise ValueError(f"Malformed sequence item tag {tag}")
        item = Dataset()
        if ilen == 0xFFFFFFFF:
            _parse_elements(r, item, explicit, stop_at_item_delim=True)
        else:
            sub = _Reader(r.data[r.pos : r.pos + ilen])
            _parse_elements(sub, item, explicit)
            r.pos += ilen
        items.append(item)
    return items


def _parse_encapsulated_pixeldata(r: _Reader) -> List[bytes]:
    """Parse an undefined-length PixelData item sequence into fragments.

    First item is the Basic Offset Table (possibly empty); remaining items are
    frame fragments. Fragments are returned without the offset table.
    """
    fragments: List[bytes] = []
    first = True
    while r.remaining() >= 8:
        tag, _, ilen = _read_element_header(r, explicit=True)
        if tag == (0xFFFE, 0xE0DD):
            break
        if tag != (0xFFFE, 0xE000):
            raise ValueError(f"Malformed encapsulated pixel data item {tag}")
        payload = r.read(ilen)
        if first:
            first = False  # offset table; drop
            continue
        fragments.append(payload)
    return fragments


def _parse_elements(
    r: _Reader,
    ds: Dataset,
    explicit: bool,
    stop_at_item_delim: bool = False,
) -> None:
    while r.remaining() >= 8:
        tag, vr, length = _read_element_header(r, explicit)
        if stop_at_item_delim and tag == (0xFFFE, 0xE00D):
            return
        if vr == "SQ" or (vr in ("UN", "") and length == 0xFFFFFFFF and tag[0] != 0x7FE0):
            ds.elements[tag] = DataElement(tag, "SQ", _skip_or_parse_sequence(r, explicit, length))
            continue
        if tag == (0x7FE0, 0x0010) and length == 0xFFFFFFFF:
            ds.pixel_fragments = _parse_encapsulated_pixeldata(r)
            ds.elements[tag] = DataElement(tag, vr or "OB", b"")
            continue
        if length == 0xFFFFFFFF:
            raise ValueError(f"Unexpected undefined length for tag {tag} vr={vr}")
        raw = r.read(length)
        ds.elements[tag] = DataElement(tag, vr, _parse_value(vr, raw))


def read_file(path: str) -> Dataset:
    with open(path, "rb") as f:
        return read_bytes(f.read())


def read_bytes(data: bytes) -> Dataset:
    """Parse a DICOM Part-10 stream (or a bare dataset, ``force``-style)."""
    ds = Dataset()
    r = _Reader(data)
    if len(data) > 132 and data[128:132] == b"DICM":
        r.pos = 132
        # File meta group: always Explicit VR LE. (0002,0000) gives its length.
        tag, vr, length = _read_element_header(r, explicit=True)
        if tag != (0x0002, 0x0000):
            raise ValueError("Missing FileMetaInformationGroupLength")
        meta_len = _parse_value(vr, r.read(length))
        meta_end = r.pos + int(meta_len)
        meta = Dataset()
        sub = _Reader(data[r.pos : meta_end])
        _parse_elements(sub, meta, explicit=True)
        r.pos = meta_end
        ds.elements.update(meta.elements)
        ts = meta.get_str((0x0002, 0x0010), EXPLICIT_VR_LE)
    else:
        # No preamble: assume bare Explicit VR LE dataset (pydicom force=True
        # analog used by the reference's png decode path, src/codec.py:205)
        ts = _sniff_bare_syntax(data)
    ds.transfer_syntax = ts

    body = data[r.pos :]
    if ts == DEFLATED_EXPLICIT_VR_LE:
        try:
            body = zlib.decompress(body, wbits=-15)
        except zlib.error as exc:
            raise ValueError(
                f"Invalid file: corrupt deflated DICOM body ({exc})"
            ) from exc
        explicit = True
    elif ts == IMPLICIT_VR_LE:
        explicit = False
    else:
        explicit = True  # Explicit VR LE and encapsulated syntaxes
    _parse_elements(_Reader(body), ds, explicit)
    return ds


def _sniff_bare_syntax(data: bytes) -> str:
    """Heuristic for headerless datasets: check if bytes 4:6 look like a VR."""
    if len(data) >= 6:
        maybe_vr = data[4:6]
        try:
            vr = maybe_vr.decode("ascii")
        except UnicodeDecodeError:
            return IMPLICIT_VR_LE
        if vr.isalpha() and vr.isupper():
            return EXPLICIT_VR_LE
    return IMPLICIT_VR_LE


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------


def _encode_element(tag: Tuple[int, int], vr: str, value: Any, explicit: bool) -> bytes:
    if isinstance(value, str):
        raw = value.encode("ascii")
        if len(raw) % 2:
            raw += b"\x00" if vr in ("UI", "OB") else b" "
    elif isinstance(value, int):
        if vr == "US":
            raw = struct.pack("<H", value)
        elif vr == "UL":
            raw = struct.pack("<I", value)
        elif vr == "SS":
            raw = struct.pack("<h", value)
        else:
            raw = str(value).encode("ascii")
            if len(raw) % 2:
                raw += b" "
    elif isinstance(value, bytes):
        raw = value
        if len(raw) % 2:
            raw += b"\x00"
    else:
        raise TypeError(f"Cannot encode {type(value)} for tag {tag}")

    out = struct.pack("<HH", tag[0], tag[1])
    if explicit:
        if vr in _LONG_VRS:
            out += vr.encode("ascii") + b"\x00\x00" + struct.pack("<I", len(raw))
        else:
            out += vr.encode("ascii") + struct.pack("<H", len(raw))
    else:
        out += struct.pack("<I", len(raw))
    return out + raw


def _required_bits(max_val: int) -> int:
    """``BitsStored = max(1, ceil(log2(max+1)))`` — the reference's rule at
    ``src/codec.py:30-32``, reproduced with exact integer math."""
    return max(1, int(max_val).bit_length())


def build_secondary_capture(
    image: np.ndarray,
    *,
    patient_name: str = "STEGO^",
    patient_id: str = "123456",
    modality: str = "OT",
    bits_stored: Optional[int] = None,
    now: Optional[datetime] = None,
) -> Dataset:
    """Build a minimal valid Secondary Capture dataset from a 2-D array.

    Field-for-field parity with the reference's ``create_dicom``
    (``src/codec.py:23-106``): SOP class ``1.2.840.10008.5.1.4.1.1.7``,
    MONOCHROME2, unsigned pixels, Window/Level centered on the intensity
    range, computed BitsStored. A 3-D ``(frames, rows, cols)`` array writes
    a multiframe file (NumberOfFrames set, frames concatenated) — the
    volume pipeline's DICOM output path.
    """
    frames = 1
    if image.ndim == 3:
        frames = int(image.shape[0])
        if frames < 1:
            raise ValueError("multiframe image needs at least one frame")
    elif image.ndim != 2:
        raise ValueError("Image must be 2-D grayscale or 3-D multiframe")
    if image.dtype not in (np.uint8, np.uint16):
        raise ValueError("Image must be uint8 or uint16")

    now = now or datetime.now()
    bits_allocated = image.dtype.itemsize * 8
    if bits_stored is None:
        bits_stored = min(_required_bits(int(image.max())), bits_allocated)
    bits_stored = min(bits_stored, bits_allocated)

    sop_instance = generate_uid()
    ds = Dataset()
    ds.transfer_syntax = EXPLICIT_VR_LE

    def put(group: int, elem: int, vr: str, value: Any) -> None:
        ds.elements[(group, elem)] = DataElement((group, elem), vr, value)

    # file meta (0002,xxxx)
    put(0x0002, 0x0002, "UI", SECONDARY_CAPTURE_SOP_CLASS)
    put(0x0002, 0x0003, "UI", sop_instance)
    put(0x0002, 0x0010, "UI", EXPLICIT_VR_LE)
    put(0x0002, 0x0012, "UI", _IMPLEMENTATION_CLASS_UID)

    # main dataset
    put(0x0008, 0x0016, "UI", SECONDARY_CAPTURE_SOP_CLASS)
    put(0x0008, 0x0018, "UI", sop_instance)
    put(0x0008, 0x0020, "DA", now.strftime("%Y%m%d"))
    put(0x0008, 0x0021, "DA", now.strftime("%Y%m%d"))
    put(0x0008, 0x0023, "DA", now.strftime("%Y%m%d"))
    put(0x0008, 0x0030, "TM", now.strftime("%H%M%S"))
    put(0x0008, 0x0033, "TM", now.strftime("%H%M%S"))
    put(0x0008, 0x0060, "CS", modality)
    put(0x0010, 0x0010, "PN", patient_name)
    put(0x0010, 0x0020, "LO", patient_id)
    put(0x0020, 0x000D, "UI", generate_uid())
    put(0x0020, 0x000E, "UI", generate_uid())
    put(0x0020, 0x0011, "IS", "1")
    put(0x0020, 0x0013, "IS", "1")
    put(0x0028, 0x0002, "US", 1)
    put(0x0028, 0x0004, "CS", "MONOCHROME2")
    if frames > 1:
        put(0x0028, 0x0008, "IS", str(frames))
    put(0x0028, 0x0010, "US", int(image.shape[-2]))
    put(0x0028, 0x0011, "US", int(image.shape[-1]))
    put(0x0028, 0x0100, "US", bits_allocated)
    put(0x0028, 0x0101, "US", bits_stored)
    put(0x0028, 0x0102, "US", bits_stored - 1)
    put(0x0028, 0x0103, "US", 0)
    window_center = int((int(image.max()) + int(image.min())) / 2)
    window_width = int(image.max()) - int(image.min())
    put(0x0028, 0x1050, "DS", str(window_center))
    put(0x0028, 0x1051, "DS", str(window_width))
    put(0x7FE0, 0x0010, "OW", np.ascontiguousarray(image).tobytes())
    return ds


def _encapsulate(fragment: bytes) -> bytes:
    """Encapsulated PixelData value: empty Basic Offset Table item + one
    frame fragment item + sequence delimiter (PS3.5 A.4)."""
    if len(fragment) % 2:
        fragment += b"\x00"
    out = struct.pack("<HHI", 0xFFFE, 0xE000, 0)                 # empty BOT
    out += struct.pack("<HHI", 0xFFFE, 0xE000, len(fragment)) + fragment
    out += struct.pack("<HHI", 0xFFFE, 0xE0DD, 0)                # delimiter
    return out


def to_bytes(
    ds: Dataset, *, deflated: bool = False, transfer_syntax: Optional[str] = None
) -> bytes:
    """Serialize a Dataset to a Part-10 byte stream.

    * default: Explicit VR LE with raw PixelData;
    * ``deflated=True``: DeflatedExplicitVRLittleEndian, as the reference's
      'png' codec path produces (``src/codec.py:151-162``);
    * ``transfer_syntax=JPEGLS_LOSSLESS / JPEG2000_LOSSLESS``: the pixel data
      is compressed through the codec registry and written **encapsulated** —
      the self-contained compressed DICOM the reference obtained by shelling
      out to ``gdcmconv --jpegls/--j2k`` (``src/codec.py:132-149``).
    """
    if transfer_syntax in ENCAPSULATED_SYNTAXES:
        from .codecs import get as get_codec

        codec = get_codec("jls" if transfer_syntax == JPEGLS_LOSSLESS else "j2k")
        arr = ds.pixel_array
        bits = ds.bits_stored if transfer_syntax == JPEGLS_LOSSLESS else None
        if transfer_syntax == JPEGLS_LOSSLESS:
            from . import jpegls_binding

            frag = jpegls_binding.encode(arr, bits=bits)
        else:
            frag = codec.encode(arr)
        enc = Dataset()
        enc.elements = dict(ds.elements)
        enc.elements[(0x7FE0, 0x0010)] = DataElement(
            (0x7FE0, 0x0010), "OB", _encapsulate(frag)
        )
        return _serialize(enc, transfer_syntax, encapsulated=True)
    ts = DEFLATED_EXPLICIT_VR_LE if deflated else EXPLICIT_VR_LE
    return _serialize(ds, ts, encapsulated=False, deflated=deflated)


def _serialize(
    ds: Dataset, ts: str, *, encapsulated: bool = False, deflated: bool = False
) -> bytes:

    meta_tags = sorted(t for t in ds.elements if t[0] == 0x0002)
    body_tags = sorted(t for t in ds.elements if t[0] != 0x0002)

    meta_payload = b""
    for tag in meta_tags:
        el = ds.elements[tag]
        if tag == (0x0002, 0x0000):
            continue
        value = el.value
        if tag == (0x0002, 0x0010):
            value = ts
        meta_payload += _encode_element(tag, el.vr, value, explicit=True)
    if (0x0002, 0x0010) not in ds.elements:
        meta_payload += _encode_element((0x0002, 0x0010), "UI", ts, explicit=True)

    meta = _encode_element((0x0002, 0x0000), "UL", len(meta_payload), explicit=True)
    meta += meta_payload

    body = b""
    for tag in body_tags:
        el = ds.elements[tag]
        if el.vr == "SQ":
            continue  # sequences are not re-emitted (not needed by this workload)
        if encapsulated and tag == (0x7FE0, 0x0010):
            # undefined-length OB element: the value is the item stream
            body += struct.pack("<HH", tag[0], tag[1])
            body += b"OB\x00\x00" + struct.pack("<I", 0xFFFFFFFF)
            body += el.value
            continue
        body += _encode_element(tag, el.vr, el.value, explicit=True)

    if deflated:
        comp = zlib.compressobj(level=9, wbits=-15)
        body = comp.compress(body) + comp.flush()

    return b"\x00" * 128 + b"DICM" + meta + body


def write_file(
    ds: Dataset,
    path: str,
    *,
    deflated: bool = False,
    transfer_syntax: Optional[str] = None,
) -> None:
    with open(path, "wb") as f:
        f.write(to_bytes(ds, deflated=deflated, transfer_syntax=transfer_syntax))


def save_image(
    image: np.ndarray,
    path: str,
    *,
    deflated: bool = False,
    transfer_syntax: Optional[str] = None,
    **kwargs: Any,
) -> Dataset:
    """Array -> Secondary Capture file on disk; returns the dataset.

    ``transfer_syntax=JPEGLS_LOSSLESS/JPEG2000_LOSSLESS`` writes a compressed
    encapsulated file (the reference's ``gdcmconv`` output equivalent)."""
    ds = build_secondary_capture(image, **kwargs)
    write_file(ds, path, deflated=deflated, transfer_syntax=transfer_syntax)
    return ds


def load_image(path: str) -> Tuple[np.ndarray, Dataset]:
    """Read a DICOM file and return ``(pixel_array, dataset)`` — the analog of
    the reference's ``load_dicom_image`` + ``.pixel_array``
    (``src/codec.py:211-213,859-860``)."""
    ds = read_file(path)
    return ds.pixel_array, ds
