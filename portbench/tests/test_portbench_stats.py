"""The end-to-end arithmetic: percentiles and rates over every request of
the window, so that one stall shows in the tail and the rate."""

import importlib.util
from pathlib import Path

import pytest

from portbench import stats

METRICS = Path(__file__).resolve().parents[1] / "metrics"


def read(name, ctx):
    spec = importlib.util.spec_from_file_location(name, METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)


def ctx(durations, window_s=None, px=1_000_000, nbytes=1_250_000):
    return stats.Context(setup_s=7.5, window_s=window_s or sum(durations),
                         durations=durations, pixels=[px] * len(durations),
                         container_bytes=[nbytes] * len(durations),
                         stages={"transport_codec": 0.5,
                                 "transport_decode": 0.25})


def test_percentiles_nearest_rank():
    d = [i / 1000 for i in range(1, 101)]       # 1..100 ms
    assert read("cycle_ms_p50", ctx(d)) == pytest.approx(50.5)
    assert read("cycle_ms_p95", ctx(d)) == pytest.approx(95.0)
    assert stats.percentile([3.0], 95) == 3.0


def test_one_stall_moves_the_tail_and_the_rate():
    steady = [0.010] * 200
    stalled = [0.010] * 189 + [0.5] * 11
    assert read("cycle_ms_p50", ctx(stalled)) == read("cycle_ms_p50",
                                                      ctx(steady))
    assert read("cycle_ms_p95", ctx(stalled)) == pytest.approx(500.0)
    assert read("cycle_ms_p95", ctx(steady)) == pytest.approx(10.0)
    assert read("mpix_per_s", ctx(stalled)) < 0.5 * read("mpix_per_s",
                                                         ctx(steady))


def test_rate_and_storage_over_the_window():
    c = ctx([0.25] * 8, window_s=2.5)
    assert read("mpix_per_s", c) == pytest.approx(8 / 2.5)
    assert read("container_bits_per_px", c) == pytest.approx(10.0)
    assert read("setup_s", c) == 7.5
    assert read("codec_ms.single", c) == pytest.approx(750 / 8)
    assert read("plan_ms.single", c) is None
    assert read("embed_roofline.single", c) is None


def test_spread_is_the_quartile_distance_over_the_median():
    assert stats.spread([1.0, 1.0, 1.0, 1.0]) == 0.0
    q = stats.spread([9.0, 10.0, 10.0, 11.0])
    assert q == pytest.approx((10.75 - 9.25) / 10.0)
