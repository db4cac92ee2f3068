# Port of codec_tcc_tpu/ops/decompose.py: the histogram runs in torch on the
# image's device; the cut-point replay is the same code.
"""Adaptive modalities decomposition.

Reference: ``adaptive_modalities_decomposition`` (``src/codec.py:561-599``) —
a sequential LSB->MSB scan accumulating per-plane mutual information until it
reaches ``beta * H(image)``. All per-plane MI terms are independent, so the
device does one histogram pass
(:func:`codec_tcc_tpu_torch.ops.histogram.value_histogram`) and the cut point
is evaluated on host in float64 with the reference's exact summation order,
so ``s`` matches NumPy and the JAX package bit-for-bit.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from . import histogram as hist_ops

__all__ = ["DecompositionResult", "decompose"]


@dataclass(frozen=True)
class DecompositionResult:
    s: int                       # cut point: number of local (LSB) planes
    nbits: int                   # total planes considered
    entropy: float               # H(image), float64, reference-exact
    target: float                # beta * H
    mi: np.ndarray               # per-plane MI curve, float64, (nbits,)
    cumulative: np.ndarray       # cumulative MI, (nbits,)


def decompose(
    image: torch.Tensor,
    beta: float = 0.8,
    nbits: Optional[int] = None,
    *,
    histogram_counts: Optional[np.ndarray] = None,
    full_curve: bool = True,
) -> DecompositionResult:
    """Find the adaptive cut point ``s``; the histogram runs on
    ``image``'s device, the MI curve on the host.

    ``nbits`` defaults to the dtype width like the reference (its defect
    B6 — callers that know DICOM BitsStored should pass it explicitly).
    A precomputed ``histogram_counts`` skips the histogram: ``image`` is
    then read only for its dtype and size, and may be a numpy array (the
    batch planner passes a zero-size proxy).

    ``full_curve=False`` stops the MI scan at the cut point like the
    reference's early-exit loop: ``s``, ``entropy``, ``target`` and the
    curve up to ``s`` are unchanged, entries past it stay 0.
    """
    if isinstance(image, torch.Tensor):
        itemsize, size = image.element_size(), int(image.numel())
    else:
        itemsize, size = np.dtype(image.dtype).itemsize, int(image.size)
    if nbits is None:
        nbits = itemsize * 8
    max_val = 255 if itemsize == 1 else 65535

    if histogram_counts is None:
        histogram_counts = (
            hist_ops.value_histogram(image, max_val + 1).cpu().numpy()
        )
    mi, h = hist_ops.plane_mi_curve(
        histogram_counts, size, nbits, max_val,
        stop_at_beta=None if full_curve else beta,
    )

    target = beta * h
    # replay the reference's sequential float64 accumulation (codec.py:580-593)
    cumulative = np.zeros(nbits, dtype=np.float64)
    acc = 0.0
    s = 1
    found = False
    for i in range(nbits):
        acc += mi[i]
        cumulative[i] = acc
        if not found and acc >= target:
            s = i + 1
            found = True
    return DecompositionResult(
        s=s, nbits=nbits, entropy=h, target=target, mi=mi, cumulative=cumulative
    )
