"""The cell ``ct512_pee.volume256`` (a PEE series through
``encode_volume``, ``pack_volume`` and ``unpack_volume``) through the
harness on the CPU at a small size: it agrees with the PEE volume
reference; its traced run reads the archive metrics and the batch PEE
route's; each fault fails its own count and no other; the bfloat16
control in the port's place is not correct on ``metric_gap`` alone; the
reference loads nothing of the program.

    python -m pytest portbench/tests/test_portbench_pee_volume.py -q
"""

import struct
import subprocess
import sys
import time
import zlib

import numpy as np
import pytest

from portbench import harness, stats
from portbench.entries import volume_pee
from portbench.reference import stgc

from .test_portbench_faults import _bfloat16_metrics

ROOT = harness.ROOT
CELL = "ct512_pee.volume256"
# four 64x64 u16 slices at the cell's 0.5 bits/px: both passes, T rises
SMALL = {"height": 64, "width": 64, "depth": 4, "pool": 1,
         "check_sample": 1, "payload_bits": 8192}
EXACT = ("header_fields", "stego_px", "map_bits", "payload_bits",
         "restored_px")


def run(traced=False, seed=2**31 + 53):
    return harness.run_cell(CELL, seed, 0.3, traced, device="cpu",
                            t0=time.perf_counter(), overrides=SMALL)


def test_pee_volume_cell_agrees_with_the_reference():
    result, checks = run()
    assert result["correct"], checks
    assert result["judged_units"] == 1 and result["failed"] == 0
    assert all(checks[k]["value"] == 0 for k in EXACT)
    assert 0 <= checks["metric_gap"]["value"] < 1e-5


def test_traced_pee_volume_cell_reads_its_metrics():
    from codec_tcc_tpu_torch import profiling

    result, _ = run(traced=True)
    metrics = result["metrics"]
    for name in ("codec_ms.archive", "plan_ms.archive", "shell_ms.archive",
                 "pee_groups.archive"):
        assert metrics[name]["value"] > 0, name
    # no copy and no device time on the CPU
    assert metrics["copy_mb.archive"]["value"] == 0
    assert "pee_roofline.archive" not in metrics
    c = profiling.counters()
    assert c["volume.pee_encodes"] == result["requests"]
    assert "volume.pee_probes" not in c
    profiling.get_profiler().reset()


@pytest.mark.cuda
def test_pee_volume_cell_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    result, checks = harness.run_cell(CELL, 2**31 + 59, 1.0, True,
                                      device="cuda", t0=time.perf_counter(),
                                      overrides=SMALL)
    assert result["correct"], checks
    assert result["device"]["busy_s"] > 0
    assert 0 < result["metrics"]["pee_roofline.archive"]["value"] < 105
    assert result["metrics"]["pee_groups.archive"]["value"] > 0


def test_readers_read_nothing_from_a_program_without_the_route():
    ctx = stats.Context(setup_s=0.0, window_s=1.0, durations=[0.1],
                        pixels=[1], container_bytes=[1], stages={},
                        trace={"range_device_s": {"embed": 1e-3},
                               "busy_s": 0.1, "window_s": 1.0},
                        work={"embed": 10, "extract": 10})
    from codec_tcc_tpu_torch import profiling

    profiling.get_profiler().reset()
    assert harness.read_metric("pee_groups.archive", ctx) is None
    assert harness.read_metric("pee_roofline.archive", ctx) is None
    ctx.trace["range_device_s"] = {"batch_embed": 1e-6, "batch_extract": 1e-6}
    share = harness.read_metric("pee_roofline.archive", ctx)
    assert share == pytest.approx(100.0 * 20 / 3.35e12 / 2e-6)


def _rebuild_stgv(blob: bytes, k: int, edit) -> bytes:
    """``blob`` with slice ``k``'s container replaced by ``edit(container)``
    and the size table rewritten."""
    v = stgc.parse_stgv(blob)
    slices = list(v["slices"])
    slices[k] = edit(slices[k])
    head = b"STGV" + struct.pack(">IIQIB", v["version"], v["depth"],
                                 v["total_bits"], v["s"], v["strategy_id"])
    head += struct.pack(f">{v['depth']}Q", *[len(s) for s in slices])
    return head + b"".join(slices)


def _header_len(c: bytes) -> int:
    return 8 + struct.unpack_from(">I", c, 4)[0]


def _other_t(c: bytes) -> bytes:
    """The PEE ext's T (its first field, right after the ext length)
    raised by one."""
    at = _header_len(c) - 4 - struct.calcsize(stgc.PEE_EXT)
    (t,) = struct.unpack_from(">I", c, at)
    return c[:at] + struct.pack(">I", t + 1) + c[at + 4:]


def _one_stego_px(c: bytes) -> bytes:
    parsed = stgc.parse_stgc(c)
    img = stgc.inflate_stego(parsed["stego_blob"]).copy()
    img[1, 1] ^= 1
    flat = img.ravel()
    raw = (flat & 0xFF).astype(np.uint8).tobytes() + (
        flat >> 8).astype(np.uint8).tobytes()
    blob = b"SDFL" + struct.pack(">BII", 3, *img.shape) + zlib.compress(raw)
    return c[:len(c) - len(parsed["stego_blob"])] + blob


def _one_map_bit(c: bytes) -> bytes:
    parsed = stgc.parse_stgc(c)
    maps = stgc.inflate_maps(parsed["bitmaps_blob"]).copy()
    maps[0] ^= 0x80
    blob = zlib.compress(maps.tobytes())
    hl = _header_len(c)
    return (c[:hl - 4] + struct.pack(">I", len(blob)) + blob
            + parsed["stego_blob"])


@pytest.mark.parametrize("fault,count", [
    (_other_t, "header_fields"), (_one_stego_px, "stego_px"),
    (_one_map_bit, "map_bits")], ids=["pee_t", "stego_px", "map_bit"])
def test_a_slice_altered_in_the_file_fails_its_count(fault, count,
                                                     monkeypatch):
    """Slice 1 of the STGV file altered after the port's own decode: its
    ext's T, one stego pixel, one overflow-map bit."""
    real = volume_pee.request

    def altered(state, unit):
        out = real(state, unit)
        out["stgv"] = _rebuild_stgv(out["stgv"], 1, fault)
        return out

    monkeypatch.setattr(volume_pee, "request", altered)
    result, checks = run()
    assert not result["correct"]
    assert checks[count]["value"] == 1
    assert all(c["value"] == 0 for k, c in checks.items()
               if k not in (count, "metric_gap")), checks
    assert checks["metric_gap"]["value"] < checks["metric_gap"]["limit"]


def test_a_payload_bit_flipped_in_one_slice(monkeypatch):
    from codec_tcc_tpu_torch.parallel import batch_pee

    real = batch_pee.decode_pee_batch

    def flipped(*a, **k):
        decs = real(*a, **k)
        decs[1].payload_bits = decs[1].payload_bits.copy()
        decs[1].payload_bits[0] ^= 1
        return decs

    monkeypatch.setattr(batch_pee, "decode_pee_batch", flipped)
    result, checks = run()
    assert not result["correct"]
    assert checks["payload_bits"]["value"] == 1
    assert all(c["value"] == 0 for k, c in checks.items()
               if k not in ("payload_bits", "metric_gap")), checks


def test_bfloat16_moments_in_the_ports_place(monkeypatch):
    """The control through the harness's own verdict: not correct on
    ``metric_gap`` alone, every exact count 0."""
    from codec_tcc_tpu_torch.parallel import volume

    monkeypatch.setattr(volume, "encode_volume",
                        _bfloat16_metrics(volume, "encode_volume", False))
    result, checks = run()
    assert not result["correct"]
    assert checks["metric_gap"]["value"] > checks["metric_gap"]["limit"]
    assert all(c["value"] == 0 for k, c in checks.items()
               if k != "metric_gap"), checks


def test_pee_volume_reference_loads_nothing_of_the_program():
    out = subprocess.run(
        [sys.executable, "-c", "import portbench.reference.pee_volume, sys\n"
         "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, timeout=600, check=True)
    loaded = set(out.stdout.split())
    assert "torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "codec_tcc_tpu",
                         "codec_tcc_tpu_torch"}
