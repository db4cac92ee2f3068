# Port of codec_tcc_tpu/analyze.py. The same code: PairResult, load_image
# (its PIL branch imports Pillow only when it runs) and _verdicts; the same
# code but for the device it takes and passes on: QualityAnalyzer.
"""Quality analyzer: the counterpart of the reference's L6 layer
(``src/mse.py``, class ``AnalisadorMSE``).

* ``load_image``    DICOM (multiframe first-frame, int16->uint16,
                    BitsStored-derived max) or PNG/PIL formats including
                    16-bit, mirroring ``carregar_imagem`` (mse.py:13-72);
* ``analyze_pair``  MSE / PSNR / global-SSIM / diff statistics with quality
                    verdicts (mse.py:181-261), from the fused moments on the
                    device (exact float64 host path for the range-normalized
                    branch);
* ``analyze_pairs`` batch over (original, stego, name) tuples with a
                    comparative summary (mse.py:265-295);
* ``report``        aggregate statistics + JSON report file (replacing
                    ``relatorio_mse.txt``, mse.py:297-351);
* windowed SSIM     beyond the reference's global-statistics simplification.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from .ops import metrics as metric_ops
from .utils.logging import get_logger, write_json_report

logger = get_logger("analyze")

ImageLike = Union[str, np.ndarray]


@dataclass
class PairResult:
    name: str
    original: str
    stego: str
    metrics: Dict[str, float]
    verdict_quality: str
    verdict_structure: str
    ssim_windowed: Optional[float] = None


def load_image(
    path_or_array: ImageLike, bits: Optional[int] = None
) -> Tuple[np.ndarray, float, int]:
    """Return (float-compatible integer array, max_value, bits_stored).

    DICOM branch mirrors mse.py:18-37 (first frame of multiframe, int16 cast
    to uint16, ``max = 2^BitsStored - 1``); the PIL branch mirrors
    mse.py:39-72 (16-bit ``I;16``, grayscale conversion for RGB).

    For ndarray inputs there is no BitsStored to consult, so ``bits`` may be
    passed explicitly; otherwise it derives from the dtype width — never from
    the data maximum (a uint16 array whose values happen to stay <= 255 is
    still a 16-bit image). ``max_value`` for arrays stays the data max: the
    metric range policy for array inputs is range=None (data-derived), which
    matches how :meth:`QualityAnalyzer.analyze_pair` calls the kernels.
    """
    if isinstance(path_or_array, np.ndarray):
        arr = path_or_array
        max_v = float(arr.max()) if arr.size else 0.0
        if bits is None:
            bits = arr.dtype.itemsize * 8 if arr.dtype.kind in "ui" else 16
        return arr, max_v, bits

    path = path_or_array
    if path.lower().endswith(".dcm"):
        from .io import dicom

        ds = dicom.read_file(path)
        arr = ds.pixel_array
        if arr.ndim > 2:
            arr = arr[0]
        if arr.dtype == np.int16:
            arr = arr.astype(np.uint16)
        bits = ds.bits_stored or arr.dtype.itemsize * 8
        return arr, float((1 << bits) - 1), bits

    from PIL import Image

    img = Image.open(path)
    if img.mode == "I;16":
        arr = np.array(img, dtype=np.uint16)
        return arr, 65535.0, 16
    if img.mode in ("L", "P"):
        return np.array(img.convert("L"), dtype=np.uint8), 255.0, 8
    if img.mode in ("RGB", "RGBA"):
        return np.array(img.convert("L"), dtype=np.uint8), 255.0, 8
    arr = np.array(img)
    if arr.dtype == np.uint16 or (arr.dtype == np.int32 and arr.max() > 255):
        return arr.astype(np.uint16), 65535.0, 16
    return arr.astype(np.uint8), 255.0, 8


def _verdicts(metrics: Dict[str, float]) -> Tuple[str, str]:
    """The reference's interpretation thresholds (mse.py:224-241)."""
    if metrics["mse"] == 0:
        q = "identical"
    elif metrics["psnr"] > 40:
        q = "excellent (imperceptible steganography)"
    elif metrics["psnr"] > 30:
        q = "good (minimal changes)"
    elif metrics["psnr"] > 20:
        q = "fair (visible changes)"
    else:
        q = "poor (significant changes)"
    if metrics["ssim"] > 0.95:
        s = "structure very well preserved"
    elif metrics["ssim"] > 0.8:
        s = "structure well preserved"
    else:
        s = "structure partially altered"
    return q, s


class QualityAnalyzer:
    """Stateful analyzer accumulating pair results (AnalisadorMSE analog);
    its moments run on ``device``."""

    def __init__(self, windowed_ssim: bool = False, window: int = 8, *,
                 device="cuda"):
        self.device = device
        self.results: List[PairResult] = []
        self.windowed_ssim = windowed_ssim
        self.window = window

    def analyze_pair(
        self,
        original: ImageLike,
        stego: ImageLike,
        name: str = "",
    ) -> PairResult:
        orig, max_o, _ = load_image(original)
        steg, max_s, _ = load_image(stego)
        if orig.shape != steg.shape:
            raise ValueError(f"Shape mismatch: {orig.shape} vs {steg.shape}")

        # single unified metric path (ops.metrics.analyze_pair); the range
        # policy follows the loaded maxima: file inputs carry BitsStored-
        # derived ranges (reference file branch, mse.py:18-37), array inputs
        # fall back to data maxima (range=None)
        metrics = metric_ops.analyze_pair(
            orig, steg,
            range_a=max_o if isinstance(original, str) else None,
            range_b=max_s if isinstance(stego, str) else None,
            device=self.device,
        )

        qv, sv = _verdicts(metrics)
        ssim_w = None
        if self.windowed_ssim:
            ssim_w = float(
                metric_ops.ssim_windowed(orig, steg, max(max_o, max_s),
                                         self.window, device=self.device)
            )
        result = PairResult(
            name=name or (os.path.basename(original) if isinstance(original, str) else "array"),
            original=original if isinstance(original, str) else "<array>",
            stego=stego if isinstance(stego, str) else "<array>",
            metrics=metrics,
            verdict_quality=qv,
            verdict_structure=sv,
            ssim_windowed=ssim_w,
        )
        self.results.append(result)
        logger.info(
            "%s: MSE=%.6f PSNR=%.2f SSIM=%.6f changed=%d (%s)",
            result.name, metrics["mse"], metrics["psnr"], metrics["ssim"],
            int(metrics["changed_pixels"]), qv,
        )
        return result

    def analyze_pairs(
        self, pairs: Sequence[Tuple[ImageLike, ImageLike, str]]
    ) -> List[PairResult]:
        out = []
        for original, stego, name in pairs:
            if isinstance(original, str) and not os.path.exists(original):
                logger.warning("missing original for %s: %s", name, original)
                continue
            if isinstance(stego, str) and not os.path.exists(stego):
                logger.warning("missing stego for %s: %s", name, stego)
                continue
            out.append(self.analyze_pair(original, stego, name))
        return out

    def summary(self) -> Dict[str, float]:
        """Aggregate statistics over accumulated results (mse.py:305-317)."""
        if not self.results:
            raise ValueError("no analyses accumulated")
        mses = [r.metrics["mse"] for r in self.results]
        psnrs = [r.metrics["psnr"] for r in self.results
                 if r.metrics["psnr"] != float("inf")]
        ssims = [r.metrics["ssim"] for r in self.results]
        out = {
            "count": float(len(self.results)),
            "mse_mean": float(np.mean(mses)),
            "mse_min": float(np.min(mses)),
            "mse_max": float(np.max(mses)),
            "ssim_mean": float(np.mean(ssims)),
            "ssim_min": float(np.min(ssims)),
            "ssim_max": float(np.max(ssims)),
        }
        if psnrs:
            out.update(
                psnr_mean=float(np.mean(psnrs)),
                psnr_min=float(np.min(psnrs)),
                psnr_max=float(np.max(psnrs)),
            )
        return out

    def report(self, path: Optional[str] = None) -> Dict[str, object]:
        """Structured JSON report (replaces relatorio_mse.txt)."""
        rep = {
            "pairs": [
                {
                    "name": r.name,
                    "original": r.original,
                    "stego": r.stego,
                    **r.metrics,
                    "verdict_quality": r.verdict_quality,
                    "verdict_structure": r.verdict_structure,
                    **({"ssim_windowed": r.ssim_windowed}
                       if r.ssim_windowed is not None else {}),
                }
                for r in self.results
            ],
            "summary": self.summary() if self.results else {},
        }
        if path:
            write_json_report(path, rep)
            logger.info("report written to %s", path)
        return rep
