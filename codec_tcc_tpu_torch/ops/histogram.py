# Port of codec_tcc_tpu/ops/histogram.py: value_histogram in torch; the
# float64 MI replay below it is the same code.
"""Device value histogram + exact host-side entropy / mutual-information math.

The reference's decomposition hot loop builds a 131,072-bin *joint* histogram
per bit plane (``src/codec.py:546-551``). Both packages collapse all of it
into **one value histogram of the image**, because a bit plane is a
deterministic function of the pixel value:

    P(bit=b, value=v) = P(value=v) * [bit_i(v) == b]

so the joint histogram for plane i is just the value histogram split by
``bit_i(v)``, the plane's marginal is two partial sums of it, and
``I(plane_i; image) == H(plane_i)`` exactly. The device computes the single
histogram (``torch.bincount``: integer counts, exact on any device); the host
then *replays the reference's float64 evaluation order* (same filtered count
arrays, same ``np.sum`` pairwise summation) so the cut point ``s`` is
bit-identical to NumPy and to the JAX package.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

__all__ = [
    "value_histogram",
    "entropy_from_counts",
    "mutual_information_from_counts",
    "plane_mi_curve",
]


def value_histogram(image: torch.Tensor, nbins: int) -> torch.Tensor:
    """Exact integer histogram of pixel values: ``(H, W) -> (nbins,) int64``
    on the image's device. ``nbins`` must exceed the max pixel value (use
    the dtype range: 256 or 65536, matching ``max_val`` at
    src/codec.py:536-540).

    ``uint16`` has no ``bincount`` in torch, so the pixels are widened to
    ``int32`` first (exact: every uint16 value fits)."""
    flat = image.reshape(-1).to(torch.int32)
    return torch.bincount(flat, minlength=nbins)[:nbins]


def entropy_from_counts(counts: np.ndarray, size: int) -> float:
    """Shannon entropy replayed exactly as ``calculate_entropy``
    (src/codec.py:489-502): filter zero counts (ascending value order), float64
    probabilities, single ``np.sum`` (pairwise summation)."""
    counts = np.asarray(counts, dtype=np.int64)
    probs = counts[counts > 0] / float(size)
    return float(-np.sum(probs * np.log2(probs)))


def mutual_information_from_counts(
    counts: np.ndarray, size: int, plane: int, max_val: int
) -> float:
    """Replay ``calculate_mutual_information`` (src/codec.py:504-559) for bit
    plane ``plane`` using only the image value histogram.

    Reconstructs the exact arrays the reference feeds to ``np.sum``:
      * counts_x = [#pixels with bit=0, #pixels with bit=1]
      * counts_y = histogram padded to ``max_val + 1`` bins
      * joint    = [counts where bit=0 (asc v), counts where bit=1 (asc v)]
    so every float64 operation happens on identical operands in identical
    order, producing the identical result (including the ~1e-15 noise between
    H(Y) and H(X,Y) that the reference's ``max(0.0, mi)`` clamps).
    """
    counts = np.asarray(counts, dtype=np.int64)
    n = max_val + 1
    counts_y = np.zeros(n, dtype=np.int64)
    counts_y[: counts.size] = counts[:n]
    return _mi_plane(counts_y, size, plane, _h_y(counts_y, size))


def _h_y(counts_y: np.ndarray, size: int) -> float:
    """H(image) term of the MI replay — plane-independent, so callers walking
    several planes of one image hoist it (identical operands and summation
    order as the inline original: bit-exact)."""
    probs_y = counts_y[counts_y > 0] / float(size)
    return float(-np.sum(probs_y * np.log2(probs_y)))


def _mi_plane(counts_y: np.ndarray, size: int, plane: int, h_y: float) -> float:
    """One plane's MI given the padded histogram and hoisted ``h_y``."""
    nz = np.nonzero(counts_y)[0]
    return _mi_plane_nz(nz, counts_y[nz], size, plane, h_y)


def _mi_plane_nz(
    nz: np.ndarray, cnz: np.ndarray, size: int, plane: int, h_y: float
) -> float:
    """MI replay on the histogram's nonzero support only.

    The reference filters every operand array to its nonzero entries before
    the float64 ``probs * log2(probs)`` sums (src/codec.py:516-544), so
    building the full ``max_val+1``-bin arrays just to mask them again is
    pure waste — a 512x512 DICOM has a few hundred distinct values against
    65,536 bins. Restricting to ``(nz, cnz)`` yields
    the IDENTICAL filtered operand arrays in the identical (ascending-value)
    order, so every ``np.sum`` sees the same floats: bit-exact, golden-
    tested (`tests/test_oracle_golden.py`)."""
    bit = (nz >> plane) & 1
    c1 = int(cnz[bit == 1].sum())
    c0 = size - c1
    # reference shortcut: constant plane or constant image -> 0.0
    if c0 == 0 or c1 == 0 or nz.size <= 1:
        return 0.0

    counts_x = np.array([c0, c1], dtype=np.int64)
    probs_x = counts_x[counts_x > 0] / float(size)
    h_x = -np.sum(probs_x * np.log2(probs_x))

    # reference operand order: bit-0 counts ascending v, then bit-1 counts
    # ascending v, zeros filtered — boolean masks keep ascending order
    joint_nz = np.concatenate([cnz[bit == 0], cnz[bit == 1]])
    joint_probs = joint_nz / float(size)
    h_xy = -np.sum(joint_probs * np.log2(joint_probs))

    return max(0.0, float(h_x + h_y - h_xy))


def plane_mi_curve(
    counts: np.ndarray, size: int, nbits: int, max_val: int,
    *, stop_at_beta: Optional[float] = None,
) -> Tuple[np.ndarray, float]:
    """Per-plane MI for all ``nbits`` planes plus total image entropy, from a
    single histogram. Returns ``(mi[nbits] float64, H float64)``.

    ``stop_at_beta``: stop once the cumulative MI (LSB->MSB, the reference's
    scan order) reaches ``stop_at_beta * H`` — the remaining entries stay 0.
    The cut-point search only ever reads the curve up to its early exit
    (src/codec.py:584-593), so planners that don't report the full curve
    skip most of the float64 histogram math. Values computed before the
    stop are bit-identical to the
    full curve's, and the threshold is the same ``beta * H`` float64 product
    the cut-point search compares against."""
    counts = np.asarray(counts, dtype=np.int64)
    # calculate_entropy bincounts without minlength -> length max_present+1;
    # filtering zeros makes the operand array identical either way.
    max_present = int(np.max(np.nonzero(counts)[0])) if counts.any() else 0
    h = entropy_from_counts(counts[: max_present + 1], size)

    n = max_val + 1
    counts_y = np.zeros(n, dtype=np.int64)
    counts_y[: counts.size] = counts[:n]
    h_y = _h_y(counts_y, size)

    nz = np.nonzero(counts_y)[0]
    cnz = counts_y[nz]
    stop_at = None if stop_at_beta is None else stop_at_beta * h
    mi = np.zeros(nbits, dtype=np.float64)
    acc = 0.0
    for p in range(nbits):
        mi[p] = _mi_plane_nz(nz, cnz, size, p, h_y)
        acc += mi[p]
        if stop_at is not None and acc >= stop_at:
            break
    return mi, h
