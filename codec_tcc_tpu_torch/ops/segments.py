# Port of codec_tcc_tpu/ops/segments.py: the same code; only import lines and prose differ.
"""Host-side segment distribution and plane plans.

``distribute_message_segments`` in the reference
(``src/codec.py:242-274``) is O(s) scalar work — quadratic
decreasing weights ``(s-i)^2``, a ``max(1, .)`` floor, excess correction on the
largest bucket, and a fixed Mersenne-Twister shuffle of destination order.
SURVEY §7 stage 2c keeps this on host. This module reproduces that math
exactly (including the reference's negative-corrected-size and
offset-past-the-end accidents, which are resolved through genuine Python slice
semantics) and *normalizes* the result into fixed-shape per-plane parameter
arrays — ``(start, length, msg_offset)`` triples padded to ``nbits`` — which is
what the fused device kernels consume (no ragged lists, SURVEY §7 hard part
"data-dependent shapes under XLA").
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from ..utils.rng import DEFAULT_SEGMENT_SHUFFLE_SEED, shuffled_indices

__all__ = [
    "SegmentPlan",
    "PlanePlan",
    "distribute_segments",
    "raster_plane_plan",
    "usable_capacity_bits",
]


@dataclass(frozen=True)
class SegmentPlan:
    """Segment-order view of the distribution (what the container stores)."""

    s: int
    total_bits: int
    sizes: Tuple[int, ...]        # indexed by plane; one entry may be negative
    indices: Tuple[int, ...]      # segment order k -> destination plane
    msg_offsets: Tuple[int, ...]  # segment order k -> message bit offset
    eff_lengths: Tuple[int, ...]  # segment order k -> usable bits (slice-clamped)


@dataclass(frozen=True)
class PlanePlan:
    """Plane-indexed, device-ready parameterization of a raster embedding.

    Arrays all have length ``nbits`` (planes >= s are zeroed); ``int32``.
    """

    nbits: int
    s: int
    total_bits: int
    starts: np.ndarray      # raster start offset per plane
    lengths: np.ndarray     # embedded bit count per plane (clamped to n_pixels)
    offsets: np.ndarray     # message bit offset per plane
    base_start_offset: int
    align_across_planes: bool
    segment: SegmentPlan

    @property
    def used_bits(self) -> int:
        return int(self.lengths.sum())


def distribute_segments(
    s: int, total_bits: int, seed: int = DEFAULT_SEGMENT_SHUFFLE_SEED
) -> SegmentPlan:
    """Bit-exact reproduction of the reference's distribution semantics."""
    weights = [(s - i) ** 2 for i in range(s)]
    total_weight = sum(weights)
    sizes = [max(1, int((w / total_weight) * total_bits)) for w in weights]
    excess = sum(sizes) - total_bits
    if excess != 0:
        sizes[sizes.index(max(sizes))] -= excess

    indices = shuffled_indices(s, seed)

    probe = range(total_bits)  # Python slice semantics (identical to str/np)
    msg_offsets: List[int] = []
    eff_lengths: List[int] = []
    bit_idx = 0
    for plane in indices:
        size = sizes[plane]
        msg_offsets.append(bit_idx)
        eff_lengths.append(len(probe[bit_idx : bit_idx + size]))
        bit_idx += size

    return SegmentPlan(
        s=s,
        total_bits=total_bits,
        sizes=tuple(sizes),
        indices=tuple(indices),
        msg_offsets=tuple(msg_offsets),
        eff_lengths=tuple(eff_lengths),
    )


def usable_capacity_bits(
    s: int, n_pixels: int, seed: int = DEFAULT_SEGMENT_SHUFFLE_SEED
) -> int:
    """Largest payload that survives the quadratic distribution intact.

    The advertised capacity ``s * H * W`` (the reference's rule,
    src/codec.py:294) is NOT reachable: the quadratic weights oversubscribe
    plane 0 (share 9/14 at s=3), and any per-plane segment beyond ``H*W``
    pixels is silently clamped (``num_bits = min(len, h*w)``). This binary
    search finds the largest total for which every effective segment fits —
    the boundary the safe pipelines validate against.
    """

    def fits(total: int) -> bool:
        plan = distribute_segments(s, total, seed)
        return sum(min(e, n_pixels) for e in plan.eff_lengths) >= total

    lo, hi = 0, s * n_pixels
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if fits(mid):
            lo = mid
        else:
            hi = mid - 1
    return lo


def raster_plane_plan(
    plan: SegmentPlan,
    n_pixels: int,
    nbits: int,
    start_offset: int = 0,
    align_across_planes: bool = True,
) -> PlanePlan:
    """Resolve a segment plan into per-plane windows for the raster strategies.

    * strategy 1 (multi-plane, src/codec.py:276-318): ``start_offset=0``,
      ``align_across_planes=True`` (every plane starts at raster 0);
    * strategy 3 (hybrid, src/codec.py:412-487): ``start_offset`` = the
      variance-chosen block offset; without alignment each plane's start
      continues after the previous plane's span, advancing in *segment* order
      (src/codec.py:482-485).
    """
    starts = np.zeros(nbits, dtype=np.int32)
    lengths = np.zeros(nbits, dtype=np.int32)
    offsets = np.zeros(nbits, dtype=np.int32)
    offset = start_offset % n_pixels if n_pixels else 0
    for k, plane in enumerate(plan.indices):
        num_bits = min(plan.eff_lengths[k], n_pixels)
        starts[plane] = offset
        lengths[plane] = num_bits
        # normalize possibly-negative reference offsets into the padded-message
        # coordinate system the device kernels use (content-equivalent: the
        # oracle verifies stego images bit-for-bit)
        offsets[plane] = max(plan.msg_offsets[k], 0)
        if not align_across_planes:
            offset = (offset + num_bits) % n_pixels
    return PlanePlan(
        nbits=nbits,
        s=plan.s,
        total_bits=plan.total_bits,
        starts=starts,
        lengths=lengths,
        offsets=offsets,
        base_start_offset=start_offset,
        align_across_planes=align_across_planes,
        segment=plan,
    )
