# Port of codec_tcc_tpu/ops/metrics.py (pair_stats, psnr_from_mse,
# quality_report): pair_stats in torch on the images' device; the two host
# functions are the same code.
"""Fused quality metrics for an image pair.

The reference computes MSE / PSNR / global-SSIM / diff statistics in separate
float64 NumPy passes on host (``src/mse.py:74-179,202-209``). Here every sum
the formulas need comes out of one set of float32 reductions on the device
that holds the images (:func:`pair_stats`), and the host finalizes them in
float64 (:func:`quality_report`).

Windowed SSIM (``ssim_windowed``) and ``analyze_pair`` of the JAX package are
still to be ported (ROADMAP.md, queue 1: analyze and capacity).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

__all__ = [
    "pair_stats",
    "quality_report",
    "psnr_from_mse",
]


def pair_stats(a: torch.Tensor, b: torch.Tensor) -> Dict[str, torch.Tensor]:
    """One-pass sums for an image pair (float32 accumulate), on the images'
    device: 0-d tensors for two ``(H, W)`` images, ``(B,)`` tensors, one
    entry per pair, for two ``(B, H, W)`` batches.

    Returns raw moments; combine with :func:`quality_report` (host). The
    float32 sums run in another order than XLA's, so the moments agree with
    the JAX package's to float32 rounding, not bit for bit; ``changed``,
    ``max_absdiff`` and the maxima are exact (integers below 2^24)."""
    af = a.to(torch.float32).flatten(-2)
    bf = b.to(torch.float32).flatten(-2)
    diff = af - bf
    adiff = diff.abs()
    return {
        "n": torch.full(af.shape[:-1], af.shape[-1], dtype=torch.float32,
                        device=a.device),
        "sum_a": af.sum(-1),
        "sum_b": bf.sum(-1),
        "sum_a2": (af * af).sum(-1),
        "sum_b2": (bf * bf).sum(-1),
        "sum_ab": (af * bf).sum(-1),
        "sum_sqdiff": (diff * diff).sum(-1),
        "sum_absdiff": adiff.sum(-1),
        "max_absdiff": adiff.amax(-1),
        # float compare: uint16 has no `!=` in torch, and float32 holds
        # every uint16 value exactly
        "changed": (af != bf).sum(-1, dtype=torch.float32),
        "max_a": af.amax(-1),
        "max_b": bf.amax(-1),
    }


def psnr_from_mse(mse: float, max_value: float) -> float:
    """``10*log10(MAX^2/MSE)``, inf when identical (src/mse.py:118-133)."""
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10((max_value**2) / mse))


def quality_report(
    stats: Dict[str, torch.Tensor],
    max_value: float | None = None,
    *,
    range_a: float | None = None,
    range_b: float | None = None,
) -> Dict[str, float]:
    """Finalize fused sums into the reference's metric set
    (MSE src/mse.py:112-116, PSNR :126-133, global SSIM :163-179, diff stats
    :202-209).

    ``range_a``/``range_b`` are the per-image value ranges that drive the
    normalization decision (``calcular_mse``'s ``max1 != max2`` test,
    src/mse.py:100); they default to the data maxima (the array-input
    behavior). ``max_value`` is the final PSNR/SSIM range and defaults to
    ``max(range_a, range_b)``."""
    s = {k: float(v) for k, v in stats.items()}
    n = s["n"]
    # range normalization branch of calcular_mse (src/mse.py:100-110): when
    # the two images' ranges differ, both are rescaled to the larger range
    # before differencing. The normalized MSE comes from the fused moments:
    # ||a*alpha - b*beta||^2 = a2*alpha^2 + b2*beta^2 - 2ab*alpha*beta
    # (mild float32 cancellation in this branch; the common equal-range case
    # uses the directly-accumulated squared diff, which is cancellation-free).
    max_a = s["max_a"] if range_a is None else float(range_a)
    max_b = s["max_b"] if range_b is None else float(range_b)
    if max_value is None:
        max_value = max(max_a, max_b) if (max_a or max_b) else 255.0
    if max_a != max_b and max_a > 0 and max_b > 0:
        alpha = max_value / max_a
        beta = max_value / max_b
    else:
        alpha = beta = 1.0
    if alpha == beta == 1.0:
        mse = s["sum_sqdiff"] / n
    else:
        mse = max(
            0.0,
            (alpha * alpha * s["sum_a2"] + beta * beta * s["sum_b2"]
             - 2.0 * alpha * beta * s["sum_ab"]) / n,
        )
    mu1 = alpha * s["sum_a"] / n
    mu2 = beta * s["sum_b"] / n
    var1 = alpha * alpha * s["sum_a2"] / n - mu1 * mu1
    var2 = beta * beta * s["sum_b2"] / n - mu2 * mu2
    cov = alpha * beta * s["sum_ab"] / n - mu1 * mu2
    c1 = (0.01 * max_value) ** 2
    c2 = (0.03 * max_value) ** 2
    ssim = ((2 * mu1 * mu2 + c1) * (2 * cov + c2)) / (
        (mu1 * mu1 + mu2 * mu2 + c1) * (var1 + var2 + c2)
    )
    return {
        "mse": mse,
        "psnr": psnr_from_mse(mse, max_value),
        "ssim": ssim,
        "mean_abs_diff": s["sum_absdiff"] / n,
        "max_abs_diff": s["max_absdiff"],
        "changed_pixels": s["changed"],
        "changed_percent": 100.0 * s["changed"] / n,
        "max_value": max_value,
    }
