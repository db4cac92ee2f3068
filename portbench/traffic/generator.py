"""The benchmark's one traffic generator: a cell's pool of inputs from
``--seed``, by the parameters of its workload file.

The images are the seeded phantoms of ``tests/torch_port_cases.py``
(``image``, ``volume``, ``payload_bits``), copied here so that the
benchmark does not depend on the test suite: a smooth body-like phantom
(an elliptic body, an organ, a bone and a gentle gradient) plus Gaussian
noise of 2% of full scale, clipped to BitsStored. Every seed gives the
same sizes; only the noise and the payload bits change with it.

Workload keys read here: ``unit`` (``image``, ``batch`` or ``volume``),
``pool`` (units generated), ``batch`` (images per batch unit), ``depth``
(slices per volume unit), ``payload_bits`` (per image, per volume for a
volume unit; defaults to the configuration's).
"""

from __future__ import annotations

from typing import List

import numpy as np


def _grid(h: int, w: int):
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    return (y - h / 2) / (h / 2), (x - w / 2) / (w / 2)


def _noisy(smooth: np.ndarray, maxval: int, dtype: str,
           rng: np.random.Generator) -> np.ndarray:
    noisy = smooth * maxval + rng.normal(0.0, 0.02 * maxval, smooth.shape)
    return np.clip(np.rint(noisy), 0, maxval).astype(dtype)


def images(h: int, w: int, dtype: str, bits_stored: int, count: int,
           seed: int, stream: int = 0) -> np.ndarray:
    """``(count, h, w)`` phantoms of ``torch_port_cases.image``, image ``k``
    with the noise of ``default_rng([seed, stream, k])``."""
    y, x = _grid(h, w)
    body = ((x / 0.85) ** 2 + (y / 0.75) ** 2 < 1.0) * 0.45
    organ = ((x + 0.3) ** 2 / 0.04 + y ** 2 / 0.09 < 1.0) * 0.25
    bone = ((x - 0.35) ** 2 + (y + 0.2) ** 2 < 0.01) * 0.35
    smooth = 0.05 + body + organ + bone + 0.1 * (x + 1.0)
    maxval = (1 << bits_stored) - 1
    return np.stack([
        _noisy(smooth, maxval, dtype, np.random.default_rng([seed, stream, k]))
        for k in range(count)])


def volume(d: int, h: int, w: int, dtype: str, bits_stored: int, seed: int,
           stream: int = 0) -> np.ndarray:
    """``(d, h, w)`` series of ``torch_port_cases.volume``: the inner
    structures move with the slice index; slice ``k`` takes the noise of
    ``default_rng([seed, stream, k])``."""
    y, x = _grid(h, w)
    body = ((x / 0.85) ** 2 + (y / 0.75) ** 2 < 1.0) * 0.45
    ramp = 0.05 + body + 0.1 * (x + 1.0)
    maxval = (1 << bits_stored) - 1
    out = np.empty((d, h, w), dtype=dtype)
    for k in range(d):
        z = k / max(d - 1, 1) - 0.5
        organ = ((x + 0.3) ** 2 / 0.04 + (y - 0.3 * z) ** 2 / 0.09 < 1.0) * 0.25
        bone = ((x - 0.35) ** 2 + (y + 0.2 + 0.2 * z) ** 2 < 0.01) * 0.35
        out[k] = _noisy(ramp + organ + bone, maxval, dtype,
                        np.random.default_rng([seed, stream, k]))
    return out


def payload(nbits: int, seed: int, stream: int, k: int) -> np.ndarray:
    """``nbits`` uniform payload bits (uint8 0/1)."""
    rng = np.random.default_rng([seed, stream, k, 1])
    return rng.integers(0, 2, nbits, dtype=np.uint8)


def make_pool(cfg: dict, wl: dict, seed: int) -> List[dict]:
    """The cell's units: ``{"images": (B, H, W)}`` or ``{"volume": (D, H,
    W)}``, with ``"payloads"`` (one bit array per image, or one for the
    volume)."""
    h, w, dt, bs = cfg["height"], cfg["width"], cfg["dtype"], cfg["bits_stored"]
    nbits = int(wl.get("payload_bits", cfg["payload_bits"]))
    units = int(wl["pool"])
    if wl["unit"] == "volume":
        return [{"volume": volume(int(wl["depth"]), h, w, dt, bs, seed, u),
                 "payloads": [payload(nbits, seed, u, 0)]}
                for u in range(units)]
    if wl["unit"] == "image":
        imgs = images(h, w, dt, bs, units, seed)
        return [{"images": imgs[u:u + 1], "payloads": [payload(nbits, seed, 0, u)]}
                for u in range(units)]
    b = int(wl["batch"])
    return [{"images": images(h, w, dt, bs, b, seed, u),
             "payloads": [payload(nbits, seed, u, k) for k in range(b)]}
            for u in range(units)]
