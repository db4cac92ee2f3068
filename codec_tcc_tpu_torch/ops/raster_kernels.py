"""Hand-written CUDA kernels of the raster path, their wrappers and counts.

Two kernels carry the default encode/decode path on an NVIDIA Hopper GPU:

* **K1** :func:`raster_embed` (``csrc/raster_embed.cu``) — the multi-plane
  raster LSB embed plus the bit-packed XOR location maps, in one launch.
  Replaces the Pallas embed tiers of ``codec_tcc_tpu/ops/pallas_embed.py``
  (``embed_batch``, ``embed_batch_padded``, ``embed_batch_preplaced``) and
  the XLA packed tier with ``xor_maps_packed_batch``.
* **K2** :func:`raster_extract` (``csrc/raster_extract.cu``) — the payload
  bits in message order, straight from the stego image. Replaces the Pallas
  extract tiers (``extract_aligned_batch``, ``extract_aligned_batch_padded``,
  ``extract_raster_batch``) and the device assembly that followed them. Its
  plan is resolved on the host into message-order segments
  (:func:`extract_segments`).

Each has a batch form, one launch per batch of equal geometry with a plan
per image (:func:`raster_embed_batch`, :func:`raster_extract_batch`): the
batch axis of the Pallas kernels' ``grid=(B, N/tile)``. The per-image plans
go to the card as one small table per batch.

Both are built from the package's own sources, with the PEE kernels, into
one library (:mod:`.kernel_library`) and bound through ``ctypes`` with a
plain C interface. A wrapper given a CUDA tensor launches its kernel on the
current stream or raises; given a CPU tensor it runs the plain torch
version from :mod:`.embed`. Nothing falls back from the kernel to the plain
version.

:data:`KERNELS` names the kernels; each launch adds one to the counter
``launch.<kernel>`` of :mod:`..profiling` (plain-version calls do not
count), so a run can show that it went through the kernels.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .. import profiling
from ..device import upload
from . import embed as embed_ops
from .kernel_library import check, library, stream_ptr

__all__ = [
    "KERNELS",
    "MAX_PLANES",
    "MAX_SEGMENTS",
    "raster_embed",
    "raster_embed_batch",
    "raster_embed_batch_plain",
    "raster_embed_plain",
    "raster_extract",
    "raster_extract_batch",
    "raster_extract_batch_plain",
    "raster_extract_plain",
    "extract_segments",
]

MAX_PLANES = 16       # RASTER_MAX_PLANES in csrc/raster_common.cuh
MAX_SEGMENTS = 4 * MAX_PLANES + 1   # RASTER_MAX_SEGMENTS there
_INT32_MAX = (1 << 31) - 1

KERNELS = ("raster_embed", "raster_extract", "raster_embed_batch",
           "raster_extract_batch")
# int32 words of one table entry: RasterBatchPlan (start, len, off per
# plane, then s) and RasterSegments (count, begin, pos, plane), as
# csrc/raster_common.cuh lays them out
_EMBED_ENTRY = 3 * MAX_PLANES + 1
_SEGMENT_ENTRY = 1 + (MAX_SEGMENTS + 1) + 2 * MAX_SEGMENTS


def _plan_lists(starts, lens, offs, s: int, n: int) -> Tuple[list, ...]:
    """Validate a plane plan and return it as lists of ints with every
    start reduced mod ``n`` (the kernels apply one ``+n`` wrap)."""
    st, ln, of = (np.asarray(v, dtype=np.int64).reshape(-1).tolist()
                  for v in (starts, lens, offs))
    npl = len(st)
    if not (len(ln) == npl and len(of) == npl and 0 < npl <= MAX_PLANES):
        raise ValueError(
            f"plane plan needs 1..{MAX_PLANES} planes of equal length, got "
            f"starts/lens/offs of {len(st)}/{len(ln)}/{len(of)}"
        )
    if not 0 <= s <= npl:
        raise ValueError(f"cut point s={s} outside [0, {npl}]")
    if min(of) < 0 or min(ln) < 0:
        raise ValueError("plane offsets and lengths must be >= 0")
    if max(of) + n > _INT32_MAX or max(ln) > _INT32_MAX:
        raise ValueError(
            "message offset + N or a plane length exceeds int32: the raster "
            "kernels index in int32 plans"
        )
    return [v % n for v in st], ln, of


def _plan_arrays(starts, lens, offs, s: int, n: int) -> Tuple[np.ndarray, ...]:
    """:func:`_plan_lists` as int32 arrays."""
    return tuple(np.asarray(v, np.int32)
                 for v in _plan_lists(starts, lens, offs, s, n))


def _check_cuda_image(t: torch.Tensor, what: str, dims: int = 2) -> None:
    if t.dtype not in (torch.uint8, torch.uint16):
        raise ValueError(f"{what} must be uint8/uint16, got {t.dtype}")
    if t.dim() != dims or not t.is_contiguous():
        raise ValueError(f"{what} must be a contiguous {dims}-D tensor")


def _batch_plans(starts, lens, offs, s, b: int, n: int):
    """Per-image ``(starts, lens, offs, s)`` of a ``(B, NP)`` plan with
    ``(B,)`` cut points, each checked by :func:`_plan_lists` (starts
    reduced mod ``n``)."""
    st, ln, of = (np.asarray(v, dtype=np.int64) for v in (starts, lens, offs))
    cuts = np.asarray(s, dtype=np.int64).reshape(-1)
    if st.ndim != 2 or st.shape[0] != b or cuts.size != b:
        raise ValueError(
            f"batch plans need (B, NP) starts/lens/offs and (B,) cut points "
            f"for B={b}, got {st.shape} and {cuts.shape}"
        )
    return [(*_plan_lists(st[i], ln[i], of[i], int(cuts[i]), n),
             int(cuts[i])) for i in range(b)]


# ---------------------------------------------------------------------------
# K1: raster embed (+ bit-packed XOR maps)
# ---------------------------------------------------------------------------


def raster_embed_plain(
    image: torch.Tensor, msg: torch.Tensor, starts, lens, offs, s: int,
    *, emit_maps: bool,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain torch version of K1: :func:`.embed.embed` plus
    :func:`.embed.xor_maps_packed_batch` over planes ``0..s-1``."""
    n = image.numel()
    st, ln, of = _plan_arrays(starts, lens, offs, s, n)
    stego = embed_ops.embed(image, msg, st, ln, of, s, st.size)
    maps = None
    if emit_maps:
        maps = embed_ops.xor_maps_packed_batch(image[None], stego[None], s)[0]
    return stego, maps


def raster_embed(
    image: torch.Tensor,          # (H, W) uint8/uint16
    msg: torch.Tensor,            # (L,) uint8 0/1 message bits, same device
    starts: Sequence[int],        # (NP,) raster start per plane, NP <= 16
    lens: Sequence[int],          # (NP,) window length per plane
    offs: Sequence[int],          # (NP,) message offset per plane
    s: int,                       # cut point: planes >= s stay untouched
    *,
    emit_maps: bool,              # also return (s, N/8) packed XOR maps
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """K1: embed every plane window and (``emit_maps``) the MSB-first
    bit-packed ``orig ^ stego`` maps of planes ``0..s-1`` in one launch.
    Message bits past ``L`` read as 0. The message holds 0/1 bytes: the
    kernel takes each byte's low bit (the plain version shifts the whole
    byte, which is the same function on 0/1). The maps come from the stego
    narrowed to the image's type, so on uint8 rows 8 and up are zero.
    Returns ``(stego, maps or None)`` on the image's device."""
    if image.device.type == "cpu":
        return raster_embed_plain(
            image, msg, starts, lens, offs, s, emit_maps=emit_maps
        )
    if image.device.type != "cuda":
        raise ValueError(f"raster_embed runs on cuda or cpu, not {image.device}")
    _check_cuda_image(image, "image")
    if msg.device != image.device or msg.dtype != torch.uint8 or msg.dim() != 1:
        raise ValueError("msg must be a 1-D uint8 tensor on the image's device")
    msg = msg.contiguous()
    n = image.numel()
    st, ln, of = _plan_arrays(starts, lens, offs, s, n)
    if emit_maps and n % 8:
        raise ValueError("packed XOR maps need H*W % 8 == 0")
    stego = torch.empty_like(image)
    maps = (
        torch.empty((s, n // 8), dtype=torch.uint8, device=image.device)
        if emit_maps else None
    )
    lib = library()
    fn = lib.raster_embed_u8 if image.dtype == torch.uint8 else lib.raster_embed_u16
    err = fn(
        image.data_ptr(), msg.data_ptr() if msg.numel() else None, msg.numel(),
        st.ctypes.data, ln.ctypes.data, of.ctypes.data, st.size, s, n,
        int(emit_maps), stego.data_ptr(),
        maps.data_ptr() if maps is not None and maps.numel() else None,
        stream_ptr(image),
    )
    check(lib, err, "raster_embed")
    profiling.count("launch.raster_embed")
    return stego, maps


def raster_embed_batch_plain(
    images: torch.Tensor, msgs: torch.Tensor, starts, lens, offs, s, *,
    emit_maps: bool, max_s: Optional[int] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain torch version of :func:`raster_embed_batch`: :func:`.embed.embed`
    per image, then :func:`.embed.xor_maps_packed_batch` over ``max_s``
    planes."""
    b, h, w = images.shape
    plans = _batch_plans(starts, lens, offs, s, b, h * w)
    max_s = _max_s(plans, max_s)
    stego = torch.stack([
        embed_ops.embed(images[i], msgs[i], st, ln, of, si, len(st))
        for i, (st, ln, of, si) in enumerate(plans)
    ])
    maps = None
    if emit_maps:
        maps = embed_ops.xor_maps_packed_batch(images, stego, max_s)
    return stego, maps


def _max_s(plans, max_s: Optional[int]) -> int:
    top = max((p[3] for p in plans), default=0)
    if max_s is None:
        return top
    if not top <= max_s <= MAX_PLANES:
        raise ValueError(
            f"max_s={max_s} outside [{top}, {MAX_PLANES}] (the largest cut "
            f"point of the batch and the plane limit)"
        )
    return max_s


def raster_embed_batch(
    images: torch.Tensor,         # (B, H, W) uint8/uint16
    msgs: torch.Tensor,           # (B, L) uint8 0/1 message bits per image
    starts, lens, offs,           # (B, NP) plane plans, NP <= 16
    s,                            # (B,) cut points
    *,
    emit_maps: bool,              # also return (B, max_s, N/8) packed maps
    max_s: Optional[int] = None,  # map rows; default: the largest cut point
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """K1 over a batch, in one launch: image ``i`` is embedded as
    :func:`raster_embed` embeds it with plan ``i``, cut point ``s[i]`` and
    message row ``i`` (bits past ``L`` read as 0). With ``emit_maps`` the
    maps are ``(B, max_s, N/8)``, MSB-first packed ``orig ^ stego``; rows
    ``p >= s[i]`` of image ``i`` are zero. The plans travel as one table
    per batch, uploaded ahead of the launch. Returns ``(stego, maps or
    None)`` on the images' device."""
    if images.device.type == "cpu":
        return raster_embed_batch_plain(images, msgs, starts, lens, offs, s,
                                        emit_maps=emit_maps, max_s=max_s)
    if images.device.type != "cuda":
        raise ValueError(
            f"raster_embed_batch runs on cuda or cpu, not {images.device}")
    _check_cuda_image(images, "images", dims=3)
    b, h, w = images.shape
    n = h * w
    if (msgs.device != images.device or msgs.dtype != torch.uint8
            or msgs.dim() != 2 or msgs.shape[0] != b):
        raise ValueError("msgs must be a (B, L) uint8 tensor on the images' "
                         "device")
    if not 1 <= b <= 65535:
        raise ValueError(f"batch of {b} images outside [1, 65535]")
    if emit_maps and n % 8:
        raise ValueError("packed XOR maps need H*W % 8 == 0")
    msgs = msgs.contiguous()
    plans = _batch_plans(starts, lens, offs, s, b, n)
    max_s = _max_s(plans, max_s)
    table = np.zeros((b, _EMBED_ENTRY), np.int32)
    for i, (st, ln, of, si) in enumerate(plans):
        npl = len(st)
        table[i, :npl] = st
        table[i, MAX_PLANES:MAX_PLANES + npl] = ln
        table[i, 2 * MAX_PLANES:2 * MAX_PLANES + npl] = of
        table[i, -1] = si
    # one copy from pinned memory, queued on the current stream ahead of
    # the launch that reads it
    table_dev = upload(table, images.device, pinned=True)
    stego = torch.empty_like(images)
    maps = (
        torch.empty((b, max_s, n // 8), dtype=torch.uint8,
                    device=images.device)
        if emit_maps else None
    )
    lib = library()
    fn = (lib.raster_embed_batch_u8 if images.dtype == torch.uint8
          else lib.raster_embed_batch_u16)
    err = fn(
        images.data_ptr(), msgs.data_ptr() if msgs.numel() else None,
        msgs.shape[1], table.ctypes.data, table_dev.data_ptr(), b, max_s, n,
        int(emit_maps), stego.data_ptr(),
        maps.data_ptr() if maps is not None and maps.numel() else None,
        stream_ptr(images),
    )
    check(lib, err, "raster_embed_batch")
    profiling.count("launch.raster_embed_batch")
    return stego, maps


# ---------------------------------------------------------------------------
# K2: raster extract (payload bits in message order)
# ---------------------------------------------------------------------------


def raster_extract_plain(
    stego: torch.Tensor, starts, lens, offs, s: int, out_len: int
) -> torch.Tensor:
    """Plain torch version of K2: :func:`.embed.extract_message_device`."""
    st, ln, of = _plan_arrays(starts, lens, offs, s, stego.numel())
    return embed_ops.extract_message_device(
        stego, st, ln, of, s, st.size, out_len
    )


def extract_segments(
    starts, lens, offs, s: int, n: int, out_len: int, pixel_bits: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Resolve a plane plan into K2's segment plan: message order
    ``[0, out_len)`` cut into ``count`` intervals, as int32 arrays
    ``(begin, pos, plane)`` of ``count + 1``, ``count`` and ``count``
    entries. Segment ``k`` holds bits ``begin[k] <= j < begin[k + 1]``
    (``begin[count] = out_len``); bit ``j`` is bit ``plane[k]`` of pixel
    ``pos[k] + j - begin[k]``, which stays below ``n`` (a window that wraps
    past the raster end is two segments), or 0 where ``plane[k] = -1``.

    The rules are the plain version's: the highest plane whose window
    covers ``j`` wins; its bit is 0 when the plane is at or past ``s`` (or
    ``pixel_bits``, the dtype's width) or when ``j`` lies ``n`` or more
    bits into its window; uncovered bits are 0; starts are taken mod ``n``.
    Neighbouring segments that continue each other are merged."""
    if not 1 <= out_len <= _INT32_MAX:
        raise ValueError(f"out_len {out_len} outside [1, 2**31 - 1]: K2 "
                         f"indexes message order in int32")
    st, ln, of = _plan_lists(starts, lens, offs, s, n)
    planes = [p for p in range(len(st)) if ln[p] > 0]
    cuts = {0, out_len}
    for p in planes:
        # window start and end, N bits in, and the wrap past the raster end
        for c in (of[p], of[p] + ln[p], of[p] + n, of[p] + n - st[p]):
            if 0 < c < out_len:
                cuts.add(c)
    bounds = sorted(cuts)
    begin, pos, plane = [], [], []
    for lo in bounds[:-1]:
        read, px = -1, 0
        for p in reversed(planes):          # the highest covering plane wins
            rel = lo - of[p]
            if 0 <= rel < ln[p]:
                if p < min(s, pixel_bits) and rel < n:
                    read, px = p, (st[p] + rel) % n
                break
        if plane and plane[-1] == read and (
                read < 0 or pos[-1] + lo - begin[-1] == px):
            continue                         # the previous segment runs on
        begin.append(lo)
        pos.append(px)
        plane.append(read)
    begin.append(out_len)
    return (np.asarray(begin, np.int32), np.asarray(pos, np.int32),
            np.asarray(plane, np.int32))


def raster_extract(
    stego: torch.Tensor,          # (H, W) uint8/uint16
    starts: Sequence[int],
    lens: Sequence[int],
    offs: Sequence[int],
    s: int,
    out_len: int,
) -> torch.Tensor:
    """K2: ``(out_len,) uint8`` payload bits. Bit ``j`` comes from the
    highest plane whose window covers it (``0 <= j - off_p < len_p``):
    ``(stego[(start_p + j - off_p) mod N] >> p) & 1`` when ``p < s`` and
    ``j - off_p < N``, else 0; uncovered bits are 0 — exactly
    ``codec_tcc_tpu.ops.host_extract.extract_raster_host``. On the GPU,
    ``out_len`` must fit int32."""
    if out_len < 1:
        raise ValueError(f"out_len must be >= 1, got {out_len}")
    if stego.device.type == "cpu":
        return raster_extract_plain(stego, starts, lens, offs, s, out_len)
    if stego.device.type != "cuda":
        raise ValueError(f"raster_extract runs on cuda or cpu, not {stego.device}")
    _check_cuda_image(stego, "stego")
    n = stego.numel()
    begin, pos, plane = extract_segments(starts, lens, offs, s, n, out_len,
                                         8 * stego.element_size())
    out = torch.empty(out_len, dtype=torch.uint8, device=stego.device)
    lib = library()
    fn = (lib.raster_extract_u8 if stego.dtype == torch.uint8
          else lib.raster_extract_u16)
    err = fn(
        stego.data_ptr(), begin.ctypes.data, pos.ctypes.data,
        plane.ctypes.data, plane.size, n, out_len, out.data_ptr(),
        stream_ptr(stego),
    )
    check(lib, err, "raster_extract")
    profiling.count("launch.raster_extract")
    return out



def raster_extract_batch_plain(
    stego: torch.Tensor, starts, lens, offs, s, out_len: int
) -> torch.Tensor:
    """Plain torch version of :func:`raster_extract_batch`:
    :func:`.embed.extract_message_device` per image."""
    b, h, w = stego.shape
    plans = _batch_plans(starts, lens, offs, s, b, h * w)
    return torch.stack([
        embed_ops.extract_message_device(stego[i], st, ln, of, si, len(st),
                                         out_len)
        for i, (st, ln, of, si) in enumerate(plans)
    ])


def raster_extract_batch(
    stego: torch.Tensor,          # (B, H, W) uint8/uint16
    starts, lens, offs,           # (B, NP) plane plans
    s,                            # (B,) cut points
    out_len: int,
) -> torch.Tensor:
    """K2 over a batch, in one launch: ``(B, out_len) uint8``, row ``i``
    what :func:`raster_extract` gives for image ``i`` with plan ``i`` and
    cut point ``s[i]``. Each plan is resolved into its segments
    (:func:`extract_segments`); the tables travel as one per batch,
    uploaded ahead of the launch. On the GPU, ``out_len`` must fit
    int32."""
    if out_len < 1:
        raise ValueError(f"out_len must be >= 1, got {out_len}")
    if stego.device.type == "cpu":
        return raster_extract_batch_plain(stego, starts, lens, offs, s,
                                          out_len)
    if stego.device.type != "cuda":
        raise ValueError(
            f"raster_extract_batch runs on cuda or cpu, not {stego.device}")
    _check_cuda_image(stego, "stego", dims=3)
    b, h, w = stego.shape
    n = h * w
    if not 1 <= b <= 65535:
        raise ValueError(f"batch of {b} images outside [1, 65535]")
    bits = 8 * stego.element_size()
    table = np.zeros((b, _SEGMENT_ENTRY), np.int32)
    for i, (st, ln, of, si) in enumerate(
            _batch_plans(starts, lens, offs, s, b, n)):
        begin, pos, plane = extract_segments(st, ln, of, si, n, out_len, bits)
        count = plane.size
        row = table[i]
        row[0] = count
        row[1:MAX_SEGMENTS + 2] = out_len
        row[1:count + 2] = begin
        row[MAX_SEGMENTS + 2:MAX_SEGMENTS + 2 + count] = pos
        row[2 * MAX_SEGMENTS + 2:] = -1
        row[2 * MAX_SEGMENTS + 2:2 * MAX_SEGMENTS + 2 + count] = plane
    table_dev = upload(table, stego.device, pinned=True)
    out = torch.empty((b, out_len), dtype=torch.uint8, device=stego.device)
    lib = library()
    fn = (lib.raster_extract_batch_u8 if stego.dtype == torch.uint8
          else lib.raster_extract_batch_u16)
    err = fn(
        stego.data_ptr(), table.ctypes.data, table_dev.data_ptr(), b, n,
        out_len, out.data_ptr(), stream_ptr(stego),
    )
    check(lib, err, "raster_extract_batch")
    profiling.count("launch.raster_extract_batch")
    return out
