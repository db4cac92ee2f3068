"""The plain reference against the port on the CPU at small sizes: every
cell's run agrees with it (each count 0, the metric gap at float32
rounding), and its control does not."""

import time

import pytest

from portbench import harness, limits

from .small import SMALL


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_port_agrees_with_the_reference(cell):
    result, checks = harness.run_cell(cell, 2**31 + 99, 0.3, False,
                                      device="cpu", t0=time.perf_counter(),
                                      overrides=SMALL[cell])
    assert result["correct"], checks
    assert result["judged_units"] >= 1 and result["failed"] == 0
    assert 0 <= checks["metric_gap"]["value"] < 1e-5


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_control_is_not_correct(cell, monkeypatch):
    """bfloat16 moments in the port's place: the metric gap passes the
    cell's limit."""
    real = harness.load_cell

    def small_cell(name):
        wl, cfg = real(name)
        for k, v in SMALL[cell].items():
            (wl if k in wl else cfg)[k] = v
        return wl, cfg

    monkeypatch.setattr(harness, "load_cell", small_cell)
    wl, _ = real(cell)
    assert limits.control_gap(cell, 5, "cpu") > float(
        wl["limits"]["metric_gap"])
