"""The cells ``blk_cr2048.single`` (block_adaptive, its own reference) and
``cr2048_pee.text`` (one PEE pass) through the harness on the CPU at a
small size: each agrees with its reference, each fault the check must see
makes the run not correct, the block cell's traced run reads its own
metrics, and ``reference/block.py`` loads nothing of the program.

    python -m pytest portbench/tests/test_portbench_block.py -q
"""

import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from portbench import harness, limits

from .test_portbench_faults import _bfloat16_metrics

ROOT = Path(__file__).resolve().parents[2]
BANNED = {"jax", "jaxlib", "flax", "codec_tcc_tpu", "codec_tcc_tpu_torch"}

# 64x64 u16 at s = 5: 3000 bits are 15% of the LSB capacity, near the
# cell's 14%, so the ranking chooses tiles; the text cell keeps its 304
SMALL = {
    "blk_cr2048.single": {"height": 64, "width": 64, "pool": 2,
                          "check_sample": 2, "payload_bits": 3000},
    "cr2048_pee.text": {"height": 64, "width": 64, "pool": 2,
                        "check_sample": 2},
}


def run(cell, traced=False, seed=2**31 + 23):
    return harness.run_cell(cell, seed, 0.3, traced, device="cpu",
                            t0=time.perf_counter(), overrides=SMALL[cell])


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_port_agrees_with_the_reference(cell):
    result, checks = run(cell)
    assert result["correct"], checks
    assert result["judged_units"] >= 1 and result["failed"] == 0
    assert 0 <= checks["metric_gap"]["value"] < 1e-5


def test_text_cell_is_one_pass_at_the_least_threshold():
    """304 bits fit pass 0 at T = 2 from 512x512 on (the 64x64 runs above
    need T = 11 and both passes: the phantom's noise spreads the errors)."""
    from portbench.reference import pee, stgc
    from portbench.traffic import generator

    wl, cfg = harness.load_cell("cr2048_pee.text")
    cfg.update(height=512, width=512)
    unit = generator.make_pool(cfg, wl, 2**31 + 3)[0]
    ref = pee.encode_image(unit["images"][0], unit["payloads"][0], cfg)
    t, passes, *_ = stgc.pee_ext(ref["header"]["ext"])
    assert (t, passes) == (2, 1) and unit["payloads"][0].size == 304


def test_traced_block_cell_reads_its_metrics():
    from codec_tcc_tpu_torch import profiling

    result, _ = run("blk_cr2048.single", traced=True)
    metrics = result["metrics"]
    assert metrics["block_rank_ms.single"]["value"] > 0
    # no device here: the embed ranges launch no kernel
    assert "block_roofline.single" not in metrics
    for name in ("codec_ms.single", "plan_ms.single", "shell_ms.single"):
        assert metrics[name]["value"] > 0
    assert profiling.counters()["block.tiles_ranked"] > 0
    profiling.get_profiler().reset()


def test_block_embed_that_returns_the_image_unchanged(monkeypatch):
    from codec_tcc_tpu_torch import pipeline

    real = pipeline._embed_block

    def unchanged(image_dev, *a):
        _, packed, stats = real(image_dev, *a)
        return image_dev.clone(), packed, stats

    monkeypatch.setattr(pipeline, "_embed_block", unchanged)
    result, checks = run("blk_cr2048.single")
    assert not result["correct"] and checks["stego_px"]["value"] > 0


def test_block_decode_with_a_payload_bit_altered(monkeypatch):
    from codec_tcc_tpu_torch.ops import host_extract

    real = host_extract.extract_block_host

    def flipped(*a, **k):
        bits = real(*a, **k)
        bits[0] ^= 1
        return bits

    monkeypatch.setattr(host_extract, "extract_block_host", flipped)
    result, checks = run("blk_cr2048.single")
    assert not result["correct"] and checks["payload_bits"]["value"] > 0


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_bfloat16_moments_in_the_ports_place(cell, monkeypatch):
    """The control through the harness's own verdict: not correct on
    ``metric_gap`` alone, every exact count 0."""
    from codec_tcc_tpu_torch import pipeline

    monkeypatch.setattr(pipeline, "encode_array",
                        _bfloat16_metrics(pipeline, "encode_array", False))
    result, checks = run(cell)
    assert not result["correct"]
    assert checks["metric_gap"]["value"] > checks["metric_gap"]["limit"]
    assert all(c["value"] == 0 for k, c in checks.items()
               if k != "metric_gap"), checks


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_control_gap_passes_the_limit(cell, monkeypatch):
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


def test_block_reference_loads_nothing_of_the_program():
    out = subprocess.run(
        [sys.executable, "-c", "import portbench.reference.block, sys\n"
         "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, timeout=600, check=True)
    assert not set(out.stdout.split()) & BANNED


def test_block_reference_ranks_exactly_with_raster_ties():
    """Keys as integers: tiles of 64 and of 32 pixels with the same
    variance tie, and a tie keeps raster order."""
    from portbench.reference import block

    # 12x8, block 8: tile 0 has 64 pixels, tile 1 (edge) 4x8 = 32
    tile, pos, sizes = block.tile_grid(8, 12, 8)
    assert sizes.tolist() == [64, 32]
    keys = block.variance_keys(np.array([16, 8]), sizes)   # 3/16 both
    assert keys[0] == keys[1] and block.tile_order(keys) == [0, 1]
    keys = block.variance_keys(np.array([16, 16]), sizes)  # 3/16 < 1/4
    assert block.tile_order(keys) == [1, 0]
    assert sorted(pos[tile == 1].tolist()) == list(range(32))


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_cell_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    result, checks = harness.run_cell(cell, 2**31 + 41, 1.0, True,
                                      device="cuda", t0=time.perf_counter(),
                                      overrides=SMALL[cell])
    assert result["correct"], checks
    assert result["device"]["busy_s"] > 0
    name = ("block_roofline.single" if cell == "blk_cr2048.single"
            else "embed_roofline.single")
    assert 0 < result["metrics"][name]["value"] < 105
