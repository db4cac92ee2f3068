"""Plane plans for K1 ``raster_embed`` and K2 ``raster_extract`` where
their chunked designs are easiest to get wrong, shared by
``chip_smoke.py`` (phase 2), ``tests/test_torch_cuda.py`` and the CPU tests
that hold the plain versions against the JAX package.

K2 writes 16 output bytes per thread: a chunk that lies inside one segment
reads its pixels with aligned vector loads, any other goes byte by byte. So
the plans put segment boundaries at every residue mod 16, wrap windows past
the raster end in the middle of a chunk, start windows at odd pixels (an
odd uint16 start is 2 bytes off a 4-byte word), alias windows onto one
message offset, run windows longer than N, give planes at or past ``s`` a
nonzero length and cut ``out_len`` at 1, 15, 16, 17 and past every window.
Each plan is ``(label, s, starts, lens, offs, out_len)`` for ``n = H*W``
pixels.

K1 embeds 16 consecutive pixels per thread: inside a window it loads their
16 consecutive message bytes as vectors, elsewhere it goes pixel by pixel.
:func:`k1_plans` adds plans whose window starts, window ends and message
offsets fall at every residue mod 16 in pixel order; for K1 ``out_len`` is
the message's length (the message is cut there, so its end falls in the
middle of a chunk and the bits past it read 0).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

Plan = Tuple[str, int, list, list, list, int]


def degenerate_plans(n: int) -> List[Plan]:
    """The reference's negative-size accident aliases two planes onto one
    message offset (the higher plane wins); a plane past s with a nonzero
    length writes zeros over its span (ops/host_extract.py:50-53); a window
    longer than N zero-fills past N."""
    return [
        ("aliased", 3, [10, n - 20, 300, 0], [500, 400, 200, 0],
         [0, 0, 450, 0], 800),
        ("past_s", 2, [0, 100, 50, 7], [300, 200, 250, 0], [0, 300, 100, 0],
         700),
        ("longer_than_n", 1, [n - 3, 0, 0, 0], [n + 40, 0, 0, 0],
         [5, 0, 0, 0], n + 100),
        ("aliased_overlap", 4, [1, 2, 3, 4], [64, 64, 64, 64],
         [0, 32, 32, 96], 160),
    ]


def start_mod_n_plan(n: int) -> Plan:
    """Untrusted containers may carry starts >= N; they are taken mod N."""
    return ("start_mod_n", 2, [n + 17, 3 * n - 1, 0, 0], [100, 60, 0, 0],
            [0, 100, 0, 0], 160)


def residue_plans(n: int, seed: int) -> List[Plan]:
    """Eight planes of random windows whose first boundary falls at residue
    r mod 16, for every r: consecutive windows at odd starts, one window
    aliased into the middle of another, lengths up to twice N."""
    rng = np.random.default_rng(seed)
    plans = []
    for r in range(16):
        lens = rng.integers(0, max(2, n // 8), 8) * 16 + r
        lens[5] = 0                                   # an empty plane
        offs = r + np.concatenate([[0], np.cumsum(lens)[:-1]])
        offs[3] = offs[2] + lens[2] // 2 + 1          # aliased mid-window
        starts = rng.integers(0, n, 8) | 1            # odd pixels
        starts[1] = n - 1 - r                         # wraps near its start
        out_len = int((offs + lens).max()) + r
        plans.append((f"residue{r}", int(rng.integers(1, 9)),
                      starts.tolist(), lens.tolist(), offs.tolist(), out_len))
    return plans


def out_len_plans(n: int) -> List[Plan]:
    """One plan cut at ``out_len`` 1, 15, 16, 17, mid-window and past every
    window."""
    starts, lens, offs = [3, n - 5, 7, 0], [40, n // 2, 200, 0], [0, 40, 33, 0]
    end = max(o + ln for o, ln in zip(offs, lens))
    return ([(f"out_len{k}", 3, starts, lens, offs, k)
             for k in (1, 15, 16, 17, 45)]
            + [("out_len_past_all", 3, starts, lens, offs, end + 37)])


def wrap_plans(n: int) -> List[Plan]:
    """Windows that wrap past the raster end in the middle of a chunk: plane
    0 wraps 12 bytes into its fourth chunk; plane 1, longer than N, wraps
    and then turns to zeros N bits in."""
    return [
        ("wrap_mid_chunk", 1, [n - 7], [100], [53], 200),
        ("wrap_longer_than_n", 2, [n - 9, 5], [n + 70, 30], [3, n + 80],
         n + 120),
    ]


def sixteen_plane_plan(n: int) -> Plan:
    """Sixteen planes of short consecutive windows, s = 12: on a uint8
    image planes 8 to 11 read zeros."""
    return ("sixteen_planes", 12, [(37 * p) % n for p in range(16)],
            [50] * 16, [50 * p for p in range(16)], 16 * 50 + 5)


def boundary_plans(n: int, seed: int = 0) -> List[Plan]:
    """Every plan above for ``n`` pixels."""
    return (degenerate_plans(n) + [start_mod_n_plan(n)]
            + residue_plans(n, seed) + out_len_plans(n) + wrap_plans(n)
            + [sixteen_plane_plan(n)])


def k1_residue_plans(n: int, seed: int) -> List[Plan]:
    """For each r in 0..15, eight planes whose windows start at pixel
    residue r + 3p mod 16, end at 5r + p and take their first message byte
    at ``off - start`` = r + 7p (the residue of every chunk's first message
    byte inside the window); plane 5 is empty, plane 6 longer than N, plane
    3 aliased into plane 2's message span; s in {5..8}, so the planes past
    s keep nonzero lengths; the message ends inside a window."""
    rng = np.random.default_rng(seed)
    plans = []
    p = np.arange(8)
    for r in range(16):
        starts = (16 * rng.integers(0, n // 16, 8) + (r + 3 * p) % 16) % n
        ends = (5 * r + p) % 16
        lens = 16 * rng.integers(0, max(2, n // 32), 8) + (ends - starts) % 16
        lens[5] = 0
        lens[6] = n + 16 * int(rng.integers(0, 4)) + r
        offs = np.zeros(8, np.int64)
        cursor = 0
        for q in range(8):
            offs[q] = 16 * -(-cursor // 16) + (starts[q] + r + 7 * q) % 16
            cursor = offs[q] + lens[q]
        offs[3] = offs[2] + lens[2] // 2
        msg_len = int(np.median(offs + lens)) + r
        plans.append((f"k1_residue{r}", 8 - r % 4, starts.tolist(),
                      lens.tolist(), offs.tolist(), msg_len))
    return plans


def k1_plans(n: int, seed: int = 0) -> List[Plan]:
    """Every plan for K1: the boundary plans of K2 and the pixel-order
    residue plans."""
    return boundary_plans(n, seed) + k1_residue_plans(n, seed)


def five_plane_plan(n: int, seed: int) -> Plan:
    """A plan as the hybrid encoder makes at capacity: five planes at
    random starts, four full and one partial, at consecutive message
    offsets (``cr2048_u16_full`` has s = 5 in a bucket of 8)."""
    rng = np.random.default_rng(seed)
    lens = [n, n, n, n, n // 5 + 3, 0, 0, 0]
    offs = [0, 0, 0, 0, 0, 0, 0, 0]
    for p in range(1, 5):
        offs[p] = offs[p - 1] + lens[p - 1]
    starts = [int(v) for v in rng.integers(0, n, 5)] + [0, 0, 0]
    return ("five_planes", 5, starts, lens, offs, offs[4] + lens[4])


def many_segment_plan(n: int) -> Plan:
    """Sixteen consecutive windows, each longer than N and wrapping: each
    plane is three segments (up to the raster end, from pixel 0, then
    zeros), 48 in all on uint16 and 24 on uint8, where planes 8-15 read
    zeros."""
    starts = [(7 + 13 * p) % n or 1 for p in range(16)]
    lens = [n + 10 + p for p in range(16)]
    offs = [int(v) for v in np.cumsum([0] + lens[:-1])]
    return ("many_segments", 16, starts, lens, offs, offs[-1] + lens[-1] + 9)


def batch_plans(plans: List[Plan], b: int, planes: int = 16):
    """The plans ``plans[i % len(plans)]`` of a batch of ``b`` images as
    the batch kernels take them: ``(s (B,), starts, lens, offs (B,
    planes), out_len)``, each plan padded with zero-length windows and
    ``out_len`` the largest of the plans'."""
    s = np.zeros(b, np.int64)
    starts, lens, offs = (np.zeros((b, planes), np.int64) for _ in range(3))
    out_len = 1
    for i in range(b):
        _, si, st, ln, of, ol = plans[i % len(plans)]
        k = len(st)
        s[i] = si
        starts[i, :k], lens[i, :k], offs[i, :k] = st, ln, of
        out_len = max(out_len, ol)
    return s, starts, lens, offs, out_len
