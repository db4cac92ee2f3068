"""The cell ``mammo4096_pee.tiled4`` (the tile route's PEE over four bands)
through the harness on the CPU at a small size: it agrees with the PEE
reference, its traced run reads the tiled passes' and entry points'
metrics, the bfloat16 control in the port's place is not correct on
``metric_gap`` alone, and a pass that returns the bands unchanged is
caught.

    python -m pytest portbench/tests/test_portbench_tiled.py -q
"""

import time

from portbench import harness

from .test_portbench_faults import _bfloat16_metrics

CELL = "mammo4096_pee.tiled4"
# 64x64 u16 over 4 bands of 16 rows: 2500 bits need both passes and T
# rises on the phantom
SMALL = {"height": 64, "width": 64, "pool": 2, "check_sample": 2,
         "payload_bits": 2500, "bands": 4}


def run(traced=False, seed=2**31 + 29):
    return harness.run_cell(CELL, seed, 0.3, traced, device="cpu",
                            t0=time.perf_counter(), overrides=SMALL)


def test_tiled_cell_agrees_with_the_reference():
    result, checks = run()
    assert result["correct"], checks
    assert result["judged_units"] >= 1 and result["failed"] == 0
    assert 0 <= checks["metric_gap"]["value"] < 1e-5


def test_traced_tiled_cell_reads_its_metrics():
    from codec_tcc_tpu_torch import profiling

    result, _ = run(traced=True)
    metrics = result["metrics"]
    assert metrics["band_pass_ms.single"]["value"] > 0
    # the bands run the kernels' plain versions here: no launch
    assert metrics["band_launches.single"]["value"] == 0
    for name in ("codec_ms.single", "plan_ms.single", "shell_ms.tiled"):
        assert metrics[name]["value"] > 0
    assert "shell_ms.single" not in metrics
    c = profiling.counters()
    assert c["tile.bands"] == 4 * c["tile.band_passes"] > 0
    profiling.get_profiler().reset()


def test_bfloat16_moments_in_the_ports_place(monkeypatch):
    """The control through the harness's own verdict: not correct on
    ``metric_gap`` alone, every exact count 0."""
    from codec_tcc_tpu_torch.parallel import tile_pee

    monkeypatch.setattr(tile_pee, "encode_array_tiled_pee",
                        _bfloat16_metrics(tile_pee, "encode_array_tiled_pee",
                                          False))
    result, checks = run()
    assert not result["correct"]
    assert checks["metric_gap"]["value"] > checks["metric_gap"]["limit"]
    assert all(c["value"] == 0 for k, c in checks.items()
               if k != "metric_gap"), checks


def test_band_passes_that_return_the_bands_unchanged(monkeypatch):
    from codec_tcc_tpu_torch.parallel import tile_pee

    real = tile_pee.embed_pass_tiled

    def unchanged(bands, *a):
        _, *rest = real(bands, *a)
        return (list(bands), *rest)

    monkeypatch.setattr(tile_pee, "embed_pass_tiled", unchanged)
    result, checks = run()
    assert not result["correct"] and checks["stego_px"]["value"] > 0
