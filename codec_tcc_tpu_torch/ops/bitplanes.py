# Port of codec_tcc_tpu/ops/bitplanes.py: split_planes, merge_planes and
# merge_local_global as elementwise torch ops on the input's device.
"""Bit-plane split / merge.

Reference semantics: ``(image >> i) & 1`` per plane
(``src/codec.py:571,789-793``) and shift-OR recombination with dtype
``uint16 iff total planes > 8`` (``src/codec.py:215-237``). Both directions
work on a dense ``(nbits, H, W)`` plane tensor and predicate on the cut
point ``s`` instead of carrying ragged per-plane lists.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import to_device

__all__ = ["split_planes", "merge_planes", "merge_local_global"]


def _shifts(nbits: int, device) -> torch.Tensor:
    return torch.arange(nbits, dtype=torch.int32, device=device).view(
        nbits, 1, 1)


def split_planes(image: torch.Tensor, nbits: int) -> torch.Tensor:
    """``(H, W) uint8/uint16 -> (nbits, H, W) uint8`` LSB-first bit planes."""
    planes = (image.to(torch.int32)[None] >> _shifts(nbits, image.device)) & 1
    return planes.to(torch.uint8)


def merge_planes(planes: torch.Tensor, nbits: int) -> torch.Tensor:
    """``(nbits, H, W) -> (H, W)``; dtype uint16 iff nbits > 8 (the
    reference's rule at src/codec.py:218-221)."""
    dtype = torch.uint16 if nbits > 8 else torch.uint8
    acc = torch.sum(planes.to(torch.int32) << _shifts(nbits, planes.device),
                    dim=0, dtype=torch.int32)
    return acc.to(dtype)


def merge_local_global(image: torch.Tensor, local_planes: torch.Tensor,
                       s) -> torch.Tensor:
    """Rebuild an image from its own global (MSB) planes and replacement local
    planes: keep bits >= s from ``image``, take bits < s from
    ``local_planes`` (``(nbits, H, W)`` uint8). Equivalent to the reference's
    ``merge_modalities(global, stego_local)`` with the globals taken from the
    original image, without materializing global planes. ``s`` is an int or
    a 0-d integer tensor."""
    nbits = local_planes.shape[0]
    s = to_device(s if isinstance(s, torch.Tensor) else np.asarray(s, np.int32),
                  image.device).to(torch.int32)
    shifts = _shifts(nbits, image.device)
    active = shifts < s
    local_bits = torch.sum(
        torch.where(active, local_planes.to(torch.int32), 0) << shifts,
        dim=0, dtype=torch.int32,
    )
    keep_mask = ~((torch.ones((), dtype=torch.int32, device=image.device)
                   << s) - 1)                   # clear the s LSBs
    merged = (image.to(torch.int32) & keep_mask) | local_bits
    return merged.to(image.dtype)
