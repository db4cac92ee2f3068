"""Plain reference of strategy ``pee`` over a volume (an STGV series), written
from the split's description:

* the passes' ceiling is the dtype's (65535 for uint16): an STGV volume
  carries no BitsStored, so every slice's container records the dtype's
  bits and its passes clip there, not at BitsStored's ceiling;
* per slice, the combined capacity by T: pass 0's exact capacity plus pass
  1's measured on the unmarked slice (:func:`.pee.capacities`);
* a discount of 64 bits a slice: the least ``T >= pee_threshold`` whose
  discounted capacities sum to the payload; the payload cut into
  contiguous chunks, each at most its slice's discounted capacity at that
  T (the last slices may take less, or nothing);
* each slice encoded as :func:`.pee.encode_image` encodes one image, on its
  chunk: its own least T, rising while the two passes fall short; a slice
  with an empty chunk keeps its pixels, one pass at ``pee_threshold``;
* where a slice cannot hold its chunk even at T = 128, the split again at
  a discount of 1024.

Departure from the program: where neither discount gives a split that
every slice holds, the program probes each slice's exact two-pass capacity
(K3 at a saturating want) before it gives up; this reference raises
instead. A benchmark cell must stay far from that band.

The STGV header: version 2, the depth, the payload's bits, ``s`` 0 and
strategy ``pee``. The metrics are the volume's, :func:`.raster.quality`
over the whole series. Nothing here imports the program or JAX.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from . import pee, raster, stgc

DISCOUNTS = (64, 1024)


def slice_capacities(volume: np.ndarray, max_val: int,
                     device="cpu") -> np.ndarray:
    """``(D, MAX_T)``: each slice's combined two-pass capacity by T."""
    caps = []
    for img in volume:
        x = torch.from_numpy(img.astype(np.int32)).to(device)
        caps.append(pee.capacities(x, 0, max_val)
                    + pee.capacities(x, 1, max_val))
    return np.stack(caps).astype(np.int64)


def split(caps: np.ndarray, total: int, t_min: int, discount: int):
    """``(T, chunk sizes)`` of the split at ``discount``: the least ``T >=
    t_min`` whose discounted capacities cover ``total`` bits, and the
    contiguous chunks it gives; None where no T does."""
    held = np.maximum(caps - discount, 0)
    for t in range(max(1, t_min), pee.MAX_T + 1):
        if int(held[:, t - 1].sum()) >= total:
            sizes, left = [], total
            for cap in held[:, t - 1]:
                sizes.append(min(left, int(cap)))
                left -= sizes[-1]
            return t, np.asarray(sizes, np.int64)
    return None


def _empty_slice(image: np.ndarray, cfg: dict, device) -> dict:
    """A slice whose chunk is empty: the least T (``pee_threshold``) and
    one pass that processes no pixel, so the stego is the slice and its
    overflow map is empty (the single-image reference takes no empty
    payload)."""
    h, w = image.shape
    x = torch.from_numpy(image.astype(np.int32)).to(device)
    none = torch.zeros(1, dtype=torch.uint8, device=device)
    t = max(1, int(cfg["pee_threshold"]))
    top = (1 << cfg["bits_stored"]) - 1
    out, over, used, nproc = pee.embed_pass(x, none, 0, 0, 0, t, top)
    nbits = cfg["bits_stored"]
    head = {
        "version": 2, "codec_id": stgc.CODEC_IDS[cfg["codec"]],
        "strategy_id": stgc.STRATEGY_IDS["pee"], "s": 0, "nbits": nbits,
        "bits_stored": nbits, "dtype_code": stgc.DTYPE_CODES[image.dtype.name],
        "flags": stgc.FLAG_HAS_BITMAPS, "width": w, "height": h,
        "start_offset": 0, "seed": cfg["seed"], "payload_bits": 0,
        "sizes": (), "indices": (), "eff_lengths": (), "plane_starts": (),
        "ext": struct.pack(stgc.PEE_EXT, t, 1, nproc, 0, used, 0),
    }
    return {"header": head, "stego": out.cpu().numpy().astype(image.dtype),
            "maps": np.packbits(over.cpu().numpy().ravel().astype(np.uint8))}


def _slices(volume: np.ndarray, bits: np.ndarray, sizes, cfg: dict,
            device):
    """Each slice's single-image reference on its chunk; None where one
    exceeds its capacity at the largest T."""
    out, off = [], 0
    for img, size in zip(volume, sizes):
        chunk = bits[off:off + int(size)]
        off += int(size)
        if not chunk.size:
            out.append(_empty_slice(img, cfg, device))
            continue
        try:
            out.append(pee.encode_image(img, chunk, cfg, device=device))
        except ValueError:
            return None
    return out


def encode_volume(volume: np.ndarray, bits: np.ndarray, cfg: dict,
                  device="cpu") -> dict:
    """What a PEE volume's encode must give: the STGV header, each slice's
    expected container (``header``, ``stego``, ``maps``), the split (``T``,
    ``slice_bits``), the stego series and the volume's float64 metrics."""
    dtype_bits = volume.dtype.itemsize * 8
    top = (1 << dtype_bits) - 1
    slice_cfg = dict(cfg, bits_stored=dtype_bits)
    total = int(bits.size)
    caps = slice_capacities(volume, top, device)
    for discount in DISCOUNTS:
        got = split(caps, total, int(cfg["pee_threshold"]), discount)
        if got is None:
            continue
        t, sizes = got
        slices = _slices(volume, bits, sizes, slice_cfg, device)
        if slices is not None:
            break
    else:
        raise ValueError(
            f"{total} bits: no histogram split of the volume holds them "
            f"(the program would probe the exact capacity here)")
    stego = np.stack([s["stego"] for s in slices])
    return {"volume_header": {"version": 2, "depth": int(volume.shape[0]),
                              "total_bits": total, "s": 0,
                              "strategy_id": stgc.STRATEGY_IDS["pee"]},
            "slices": slices, "T": t, "slice_bits": sizes, "stego": stego,
            "metrics": raster.quality(volume, stego)}
