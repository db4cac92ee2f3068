"""The kernel layer's work counts, by hand, at one small shape each and at
the parity cases' sizes."""

import struct

from portbench import work
from portbench.reference import stgc


def test_window_union():
    assert work.window_union([60, 10], [10, 5], 64) == 15      # one wraps
    assert work.window_union([0, 0], [5, 3], 64) == 5          # aligned
    assert work.window_union([5, 70], [64, 3], 64) == 64       # whole image


def test_raster_small_by_hand():
    # 8x8 uint8, s=2, 10 payload bits: 64 read + 64 written + 2 planes of
    # 8 bytes + 2 payload bytes; extract: 10 window pixels + 2 bytes
    assert work.raster_embed_bytes(64, 1, 2, 10) == 64 + 64 + 16 + 2
    assert work.raster_extract_bytes(64, 1, [60, 6], [4, 6], 10) == 10 + 2


def test_raster_parity_size():
    # 512x512 uint16, s = 5, the 304-bit text on consecutive windows
    n = 512 * 512
    assert work.raster_embed_bytes(n, 2, 5, 304) == 1_048_576 + 163_840 + 38
    starts = [1000, 1140, 1228, 1277, 1299]
    lens = [140, 88, 49, 22, 5]
    assert work.raster_extract_bytes(n, 2, starts, lens, 304) == 608 + 38


def test_pee_small_by_hand():
    # 4x4 uint16, one pass of 3 bits: 32 read + 32 written + 1 bit byte,
    # and the 16-bit overflow map's 2 bytes
    assert work.pee_bytes(16, 2, (3,)) == 32 + 32 + 1 + 2


def test_pee_parity_size_two_passes():
    n = 2048 * 2048
    got = work.pee_bytes(n, 2, (1_660_978, 1_339_022))
    assert got == 2 * (2 * n * 2) + 207_623 + 167_378 + 524_288


def _container(strategy, s, ext=b"", starts=(), lens=(), bits=304):
    head = struct.pack(">8B", 2, 5, strategy, s, 12, 12, 2, 2)
    head += struct.pack(">4I", 512, 512, 0, 42) + struct.pack(">Q", bits)
    head += struct.pack(f">{s}i", *([0] * s)) + bytes(range(s))
    head += struct.pack(f">{s}I", *lens) + struct.pack(f">{s}I", *starts)
    head += struct.pack(">I", len(ext)) + ext + struct.pack(">I", 0)
    return b"STGC" + struct.pack(">I", len(head)) + head


def test_counts_follow_the_plan_not_the_kernels():
    raster = _container(3, 2, starts=(10, 20), lens=(10, 5), bits=15)
    w = work.container_work(raster)
    assert w["embed"] == 2 * 512 * 512 * 2 + 2 * 32768 + 2
    assert w["extract"] == 15 * 2 + 2
    one = _container(4, 0, ext=struct.pack(stgc.PEE_EXT, 2, 1, 100, 0, 300,
                                           0), bits=300)
    two = _container(4, 0, ext=struct.pack(stgc.PEE_EXT, 2, 2, 100, 90, 300,
                                           200), bits=500)
    n = 512 * 512
    assert work.container_work(one)["embed"] == 4 * n + 38 + n // 8
    assert work.container_work(two)["extract"] == 8 * n + 38 + 25 + n // 8
