"""The control of the correctness check: the reference put in the port's
place with its quality metrics computed one precision below the one the
configurations state. The port sums the metric moments in float32; the
control computes them in bfloat16 (inputs, sums and formulas), as a
change that narrowed the moments would. The check must find it wrong.
"""

from __future__ import annotations

import numpy as np
import torch


def quality(a: np.ndarray, b: np.ndarray, device,
            dtype=torch.bfloat16) -> dict:
    """:func:`raster.quality` in ``dtype`` on ``device``."""
    a = torch.from_numpy(np.ascontiguousarray(a)).to(device).to(dtype)
    b = torch.from_numpy(np.ascontiguousarray(b)).to(device).to(dtype)
    max_a, max_b = a.max(), b.max()
    max_range = torch.maximum(max_a, max_b)
    if bool(max_a != max_b) and bool(max_a > 0) and bool(max_b > 0):
        a = (a / max_a) * max_range
        b = (b / max_b) * max_range
    diff = a - b
    mse = torch.mean(diff * diff)
    psnr = 10.0 * torch.log10(max_range * max_range / mse)
    mu1, mu2 = torch.mean(a), torch.mean(b)
    var1 = torch.mean((a - mu1) ** 2)
    var2 = torch.mean((b - mu2) ** 2)
    cov = torch.mean((a - mu1) * (b - mu2))
    c1 = (0.01 * max_range) ** 2
    c2 = (0.03 * max_range) ** 2
    ssim = ((2 * mu1 * mu2 + c1) * (2 * cov + c2)
            / ((mu1 ** 2 + mu2 ** 2 + c1) * (var1 + var2 + c2)))
    return {"mse": float(mse), "psnr": float(psnr), "ssim": float(ssim)}
