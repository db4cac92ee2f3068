# Port of codec_tcc_tpu/ops/metrics.py: pair_stats and ssim_windowed in
# torch on the images' device; psnr_from_mse, quality_report and
# host_pair_report are the same code; analyze_pair is the JAX routing with
# the moments on ``device``; encode_report, the port's own, gives the
# single-image encodes that routing.
"""Fused quality metrics for an image pair.

The reference computes MSE / PSNR / global-SSIM / diff statistics in separate
float64 NumPy passes on host (``src/mse.py:74-179,202-209``). Here every sum
the formulas need comes out of one set of float32 reductions on the device
that holds the images (:func:`pair_stats`), and the host finalizes them in
float64 (:func:`quality_report`). The range-normalised branch, where float32
moments would cancel, runs in float64 on the host (:func:`host_pair_report`);
:func:`analyze_pair` routes between the two as the JAX package does.

Beyond parity, :func:`ssim_windowed` adds mean windowed SSIM over
non-overlapping ``window x window`` patches (the reference's "simplified"
SSIM uses one global mean/variance, src/mse.py:163-179).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..device import resolve_device, to_device

__all__ = [
    "analyze_pair",
    "encode_report",
    "pair_stats",
    "quality_report",
    "psnr_from_mse",
    "ssim_windowed",
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


def encode_report(stats: Dict[str, np.ndarray], original: np.ndarray,
                  stego: np.ndarray) -> Dict[str, float]:
    """The metric set of one encoded pair, routed as :func:`analyze_pair`
    routes: from the moments ``stats`` (host values of :func:`pair_stats`)
    where the two data maxima agree, and where they differ, the
    normalisation branch, in float64 from the host arrays
    (:func:`host_pair_report`; float32 moments cancel there: 1.6% off the
    MSE on a 61x67 u16 image whose one 4095 pixel the payload lowered)."""
    max_a, max_b = float(stats["max_a"]), float(stats["max_b"])
    if max_a != max_b and max_a > 0 and max_b > 0:
        return host_pair_report(original, stego)
    return quality_report(stats)


def host_pair_report(
    a,
    b,
    max_value: float | None = None,
    *,
    range_a: float | None = None,
    range_b: float | None = None,
) -> Dict[str, float]:
    """Float64 host computation of the full metric set: the reference's
    range-normalization branch (different ranges), where float32 fused
    moments lose the signal to cancellation (sum(a^2) ~ 5e9 vs a
    normalized-MSE numerator ~ 1e5). ``range_a``/``range_b`` default to the
    data maxima (see :func:`quality_report` for the policy)."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    max_a = float(a.max()) if range_a is None else float(range_a)
    max_b = float(b.max()) if range_b is None else float(range_b)
    if max_value is None:
        max_value = max(max_a, max_b) if (max_a or max_b) else 255.0
    raw_absdiff = np.abs(a - b)
    if max_a != max_b and max_a > 0 and max_b > 0:
        an = (a / max_a) * max_value
        bn = (b / max_b) * max_value
    else:
        an, bn = a, b
    diff = an - bn
    mse = float(np.mean(diff * diff))
    mu1, mu2 = float(np.mean(an)), float(np.mean(bn))
    var1, var2 = float(np.var(an)), float(np.var(bn))
    cov = float(np.mean((an - mu1) * (bn - mu2)))
    c1 = (0.01 * max_value) ** 2
    c2 = (0.03 * max_value) ** 2
    ssim = ((2 * mu1 * mu2 + c1) * (2 * cov + c2)) / (
        (mu1 * mu1 + mu2 * mu2 + c1) * (var1 + var2 + c2)
    )
    changed = float(np.sum(a != b))
    return {
        "mse": mse,
        "psnr": psnr_from_mse(mse, max_value),
        "ssim": ssim,
        "mean_abs_diff": float(np.mean(raw_absdiff)),
        "max_abs_diff": float(np.max(raw_absdiff)),
        "changed_pixels": changed,
        "changed_percent": 100.0 * changed / a.size,
        "max_value": max_value,
    }


def analyze_pair(
    original,
    stego,
    *,
    range_a: float | None = None,
    range_b: float | None = None,
    max_value: float | None = None,
    device="cuda",
) -> Dict[str, float]:
    """THE metric entry point for an image pair (the reference's
    ``analisar_par_imagens`` core, src/mse.py:181-261) with an explicit range
    policy. The reference has two branches:

    * **array / data-max policy** (``calcular_psnr`` default and the operand
      maxima of ``calcular_mse``, src/mse.py:100-110): leave ``range_a``/
      ``range_b`` as ``None``; the ranges are the data maxima;
    * **file / BitsStored policy** (``carregar_imagem``'s DICOM branch,
      src/mse.py:18-37): pass the loaded ``2^BitsStored - 1`` ranges.

    Cross-range normalization fires iff ``range_a != range_b`` (the
    reference's ``max1 != max2`` test) and rescales both images toward the
    final range before differencing. ``max_value`` overrides that final
    PSNR/SSIM range only (default ``max(range_a, range_b)``).

    Routing: the fused moments on ``device`` serve the equal-range case
    (cancellation-free); the normalization branch uses exact float64 host
    math, where float32 moments would cancel. Arrays of any rank reduce as
    one (a volume gives one report)."""
    original = np.asarray(original)
    stego = np.asarray(stego)
    # when both ranges are supplied, the branch is decidable without touching
    # the pixels: skip the device pass if the host branch fires
    ra = None if range_a is None else float(range_a)
    rb = None if range_b is None else float(range_b)
    if ra is not None and rb is not None and ra != rb and ra > 0 and rb > 0:
        return host_pair_report(original, stego, max_value, range_a=ra, range_b=rb)
    dev = resolve_device(device)
    stats = pair_stats(to_device(original.reshape(1, -1), dev),
                       to_device(stego.reshape(1, -1), dev))
    if ra is None:
        ra = float(stats["max_a"])
    if rb is None:
        rb = float(stats["max_b"])
    if ra != rb and ra > 0 and rb > 0:
        return host_pair_report(original, stego, max_value, range_a=ra, range_b=rb)
    return quality_report(stats, max_value, range_a=ra, range_b=rb)


def ssim_windowed(a, b, max_value: float, window: int = 8, *,
                  device="cuda") -> torch.Tensor:
    """Mean windowed SSIM over the non-overlapping ``window x window``
    patches (uniform weights; the JAX package's ``reduce_window`` with
    stride = window, VALID), float32 on ``device`` (tensors move there).
    Returns a 0-d tensor."""
    import torch.nn.functional as F

    dev = resolve_device(device)
    af = to_device(a, dev).to(torch.float32)
    bf = to_device(b, dev).to(torch.float32)

    def box(x):
        return F.avg_pool2d(x[None, None], window, stride=window)[0, 0]

    mu1, mu2 = box(af), box(bf)
    s11 = box(af * af) - mu1 * mu1
    s22 = box(bf * bf) - mu2 * mu2
    s12 = box(af * bf) - mu1 * mu2
    c1 = (0.01 * max_value) ** 2
    c2 = (0.03 * max_value) ** 2
    ssim_map = ((2 * mu1 * mu2 + c1) * (2 * s12 + c2)) / (
        (mu1 * mu1 + mu2 * mu2 + c1) * (s11 + s22 + c2)
    )
    return torch.mean(ssim_map)
