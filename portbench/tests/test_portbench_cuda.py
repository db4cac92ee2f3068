"""The harness on the card at the small sizes: every cell correct, its
traced run with device time inside the embed and extract ranges.

    python -m pytest portbench/tests -m cuda -q
"""

import time

import pytest

from portbench import harness, limits

from .small import SMALL


def _need_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_cell_on_the_card(cell):
    _need_card()
    result, checks = harness.run_cell(cell, 2**31 + 41, 1.0, True,
                                      device="cuda", t0=time.perf_counter(),
                                      overrides=SMALL[cell])
    assert result["correct"], checks
    assert result["device"]["busy_s"] > 0
    assert result["breakdown"]["device_ops"]
    if cell.endswith(".single"):
        share = result["metrics"]["embed_roofline.single"]["value"]
        assert 0 < share < 105


@pytest.mark.cuda
def test_control_on_the_card():
    _need_card()
    wl, _ = harness.load_cell("mr512_hybrid.single")
    assert limits.control_gap("mr512_hybrid.single", 3, "cuda") > float(
        wl["limits"]["metric_gap"])
