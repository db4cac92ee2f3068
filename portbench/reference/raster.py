"""Plain NumPy reference of the raster strategies (``hybrid``,
``multi_plane``): cut point, segment plan, hybrid start, stego pixels,
XOR location maps and the quality metrics, for one image, a batch of
images and a volume.

The cut point, the segment distribution and the metric formulas are a
frozen copy of the upstream semantics as ``tests/oracle/numpy_ref.py``
states them (``src/codec.py:489-599, 242-274``, ``src/mse.py:100-179``);
the rest follows the STGC v2 format's description. Nothing here imports
the program or JAX.
"""

from __future__ import annotations

import random
from typing import List

import numpy as np

from . import stgc


# -- copied from tests/oracle/numpy_ref.py: entropy, MI, cut point ---------


def entropy(image: np.ndarray) -> float:
    counts = np.bincount(image.ravel())
    probs = counts[counts > 0] / image.size
    return float(-np.sum(probs * np.log2(probs)))


def mutual_information(bit_plane: np.ndarray, image: np.ndarray) -> float:
    if bit_plane.min() == bit_plane.max() or image.min() == image.max():
        return 0.0
    bp = bit_plane.ravel()
    im = image.ravel()
    counts_x = np.bincount(bp, minlength=2)
    probs_x = counts_x[counts_x > 0] / bit_plane.size
    h_x = -np.sum(probs_x * np.log2(probs_x))
    max_val = 255 if image.dtype == np.uint8 else 65535
    counts_y = np.bincount(im, minlength=max_val + 1)
    probs_y = counts_y[counts_y > 0] / image.size
    h_y = -np.sum(probs_y * np.log2(probs_y))
    combined = bp.astype(np.int32) * (max_val + 1) + im.astype(np.int32)
    joint_counts = np.bincount(combined, minlength=2 * (max_val + 1))
    joint_probs = joint_counts[joint_counts > 0] / image.size
    h_xy = -np.sum(joint_probs * np.log2(joint_probs))
    return max(0.0, float(h_x + h_y - h_xy))


def cut_point(image: np.ndarray, beta: float, nbits: int) -> int:
    """The adaptive cut point ``s`` (LSB->MSB MI sum reaching
    ``beta * H``); a volume is one array."""
    target = beta * entropy(image)
    cumulative = 0.0
    for i in range(nbits):
        plane = (image >> np.array(i, image.dtype)) & np.array(1, image.dtype)
        cumulative += mutual_information(plane, image)
        if cumulative >= target:
            return i + 1
    return 1


def distribute_segments(s: int, total_bits: int, seed: int):
    """``(sizes by plane, indices in segment order, message offsets and
    effective lengths in segment order)``."""
    weights = [(s - i) ** 2 for i in range(s)]
    total_weight = sum(weights)
    sizes = [max(1, int((w / total_weight) * total_bits)) for w in weights]
    excess = sum(sizes) - total_bits
    if excess != 0:
        sizes[sizes.index(max(sizes))] -= excess
    indices = list(range(s))
    random.Random(seed).shuffle(indices)
    probe = range(total_bits)
    offsets, eff = [], []
    bit_idx = 0
    for plane in indices:
        offsets.append(bit_idx)
        eff.append(len(probe[bit_idx:bit_idx + sizes[plane]]))
        bit_idx += sizes[plane]
    return sizes, indices, offsets, eff


def quality(a: np.ndarray, b: np.ndarray) -> dict:
    """MSE, PSNR and global SSIM of a pair in float64, the ranges from the
    data maxima (``src/mse.py:100-179``)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    max_a, max_b = float(a.max()), float(b.max())
    max_range = max(max_a, max_b)
    if max_a != max_b and max_a > 0 and max_b > 0:
        a = (a / max_a) * max_range
        b = (b / max_b) * max_range
    diff = a - b
    mse = float(np.mean(diff * diff))
    psnr = float("inf") if mse == 0 else float(
        10.0 * np.log10(max_range ** 2 / mse))
    mu1, mu2 = np.mean(a), np.mean(b)
    var1, var2 = np.var(a), np.var(b)
    cov = np.mean((a - mu1) * (b - mu2))
    c1 = (0.01 * max_range) ** 2
    c2 = (0.03 * max_range) ** 2
    ssim = float((2 * mu1 * mu2 + c1) * (2 * cov + c2)
                 / ((mu1 ** 2 + mu2 ** 2 + c1) * (var1 + var2 + c2)))
    return {"mse": mse, "psnr": psnr, "ssim": ssim}


# -- the raster embed -------------------------------------------------------


def usable_capacity(s: int, n: int, seed: int) -> int:
    """The largest payload whose every segment fits its plane."""
    def fits(total: int) -> bool:
        return sum(min(e, n) for e in
                   distribute_segments(s, total, seed)[3]) >= total

    lo, hi = 0, s * n
    while lo < hi:
        mid = (lo + hi + 1) // 2
        lo, hi = (mid, hi) if fits(mid) else (lo, mid - 1)
    return lo


def hybrid_start(image: np.ndarray, block: int) -> int:
    """Raster offset of the first block of plane 0 with the largest
    binary variance ``c * (k - c) / k**2``. Equal rationals divide to equal
    doubles, so the float scores keep every tie."""
    h, w = image.shape
    nh, nw = -(-h // block), -(-w // block)
    bits = np.pad((image & 1).astype(np.int64),
                  ((0, nh * block - h), (0, nw * block - w)))
    c = bits.reshape(nh, block, nw, block).sum(axis=(1, 3))
    bh = np.minimum(block, h - np.arange(nh) * block)[:, None]
    bw = np.minimum(block, w - np.arange(nw) * block)[None, :]
    k = bh * bw
    best = int(np.argmax((c * (k - c) / (k * k)).ravel()))
    return (best // nw) * block * w + (best % nw) * block


def plane_bucket(s: int, dtype_bits: int) -> int:
    """The plane count a container of a volume slice records as ``nbits``."""
    return min(4 if s <= 4 else 8 if s <= 8 else dtype_bits, dtype_bits)


def embed(image: np.ndarray, bits: np.ndarray, s: int, start: int,
          align: bool, seed: int) -> dict:
    """One image's raster embed at cut point ``s`` from raster offset
    ``start``: the plan's container fields, the stego and the packed XOR
    maps."""
    h, w = image.shape
    n = h * w
    sizes, indices, offsets, eff = distribute_segments(s, int(bits.size), seed)
    flat = image.ravel().copy()
    starts, lengths = [0] * s, [0] * s
    offset = start % n
    for k, plane in enumerate(indices):
        num = min(eff[k], n)
        seg = bits[offsets[k]:offsets[k] + num].astype(flat.dtype)
        pos = (offset + np.arange(num)) % n
        one = flat.dtype.type(1 << plane)
        flat[pos] = (flat[pos] & ~one) | (seg << flat.dtype.type(plane))
        starts[plane], lengths[plane] = offset, num
        if not align:
            offset = (offset + num) % n
    stego = flat.reshape(h, w)
    diff = (image ^ stego).ravel()
    maps = np.stack([np.packbits(((diff >> p) & 1).astype(np.uint8))
                     for p in range(s)]) if s else np.zeros((0, n // 8), np.uint8)
    return {"s": s, "start_offset": start, "sizes": tuple(sizes),
            "indices": tuple(indices), "eff_lengths": tuple(lengths),
            "plane_starts": tuple(starts), "stego": stego, "maps": maps}


def header(e: dict, cfg: dict, image: np.ndarray, payload_bits: int,
           nbits: int, align: bool) -> dict:
    """The container header fields the plan ``e`` gives."""
    h, w = image.shape
    return {
        "version": 2, "codec_id": stgc.CODEC_IDS[cfg["codec"]],
        "strategy_id": stgc.STRATEGY_IDS[cfg["strategy"]], "s": e["s"],
        "nbits": nbits, "bits_stored": nbits,
        "dtype_code": stgc.DTYPE_CODES[image.dtype.name],
        "flags": (stgc.FLAG_ALIGN if align else 0) | stgc.FLAG_HAS_BITMAPS
        | stgc.FLAG_PACKED,
        "width": w, "height": h, "start_offset": e["start_offset"],
        "seed": cfg["seed"], "payload_bits": payload_bits,
        "sizes": e["sizes"], "indices": e["indices"],
        "eff_lengths": e["eff_lengths"], "plane_starts": e["plane_starts"],
        "ext": b"",
    }


def encode_image(image: np.ndarray, bits: np.ndarray, cfg: dict,
                 device=None) -> dict:
    """What one image's encode must give: ``header`` fields, ``stego``,
    packed ``maps`` and float64 ``metrics`` (NumPy on the host: ``device``
    is not used)."""
    nbits = min(cfg["bits_stored"], image.dtype.itemsize * 8)
    s = cut_point(image, cfg["beta"], nbits)
    align = cfg["strategy"] == "multi_plane" or bool(
        cfg.get("align_across_planes", False))
    start = (hybrid_start(image, cfg["search_block_size"])
             if cfg["strategy"] == "hybrid" else 0)
    e = embed(image, bits, s, start, align, cfg["seed"])
    return {"header": header(e, cfg, image, int(bits.size), nbits, align),
            "stego": e["stego"], "maps": e["maps"],
            "metrics": quality(image, e["stego"])}


def encode_volume(volume: np.ndarray, bits: np.ndarray, cfg: dict) -> dict:
    """What a volume's encode must give: one global cut point over the
    dtype's planes, the payload split into contiguous chunks of at most
    the slice's usable capacity, each slice a raster embed; the STGV
    header, each slice's expected container, and the volume's metrics."""
    d, h, w = volume.shape
    dtype_bits = volume.dtype.itemsize * 8
    s = cut_point(volume, cfg["beta"], dtype_bits)
    cap = usable_capacity(s, h * w, cfg["seed"])
    nbits = plane_bucket(s, dtype_bits)
    align = cfg["strategy"] == "multi_plane" or bool(
        cfg.get("align_across_planes", False))
    slices, stego = [], np.empty_like(volume)
    off = 0
    for i in range(d):
        take = min(int(bits.size) - off, cap)
        chunk = bits[off:off + take]
        off += take
        start = (hybrid_start(volume[i], cfg["search_block_size"])
                 if cfg["strategy"] == "hybrid" else 0)
        e = embed(volume[i], chunk, s, start, align, cfg["seed"])
        stego[i] = e["stego"]
        slices.append({"header": header(e, cfg, volume[i], take, nbits, align),
                       "stego": e["stego"], "maps": e["maps"]})
    return {"volume_header": {"version": 2, "depth": d,
                              "total_bits": int(bits.size), "s": s,
                              "strategy_id": stgc.STRATEGY_IDS[cfg["strategy"]]},
            "slices": slices, "stego": stego,
            "metrics": quality(volume, stego)}


def header_mismatches(got: dict, want: dict) -> List[str]:
    """The header fields in which a parsed container differs."""
    return [k for k, v in want.items() if got.get(k) != v]


def count_map_bits(got: np.ndarray, want: np.ndarray) -> int:
    """Differing bits of two packed maps (all of them if sizes differ)."""
    got, want = np.asarray(got, np.uint8).ravel(), np.asarray(
        want, np.uint8).ravel()
    if got.size != want.size:
        return 8 * max(got.size, want.size)
    return int(np.unpackbits(got ^ want).sum())
