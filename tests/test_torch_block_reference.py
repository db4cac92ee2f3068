"""Strategy ``block_adaptive`` in the port against the benchmark's plain
reference (``portbench/reference/block.py``, written from the scheme's
description, sharing no code with the port), on the CPU: the port's
container, decoded payload and restored original are judged as the
benchmark judges them (``judge.image``), on both tilings (uniform, and
edge tiles on both axes), both dtypes, two block sizes and three payloads;
a reference that breaks key ties the wrong way is caught; and the block
fill's spans and counters count what each side ranks and places."""

import numpy as np
import pytest
import torch

from codec_tcc_tpu_torch import EncodeConfig, pipeline, profiling

pytest.importorskip("portbench")
from portbench.reference import block as block_ref  # noqa: E402
from portbench.reference import judge, raster  # noqa: E402
from portbench.traffic import generator  # noqa: E402

torch.set_num_threads(1)

BITS_STORED = {"uint8": 8, "uint16": 12}
CASES = [(h, w, dt, blk, load) for h, w in ((64, 64), (61, 67))
         for dt in ("uint8", "uint16") for blk in (8, 5)
         for load in ("text", "half", "full")]


def _cfg(dtype, block):
    return {"strategy": "block_adaptive", "beta": 0.4, "codec": "deflate",
            "seed": 42, "bits_stored": BITS_STORED[dtype],
            "block_size": block}


def _payload(img, cfg, load):
    s = raster.cut_point(img, cfg["beta"], cfg["bits_stored"])
    cap = raster.usable_capacity(s, img.size, cfg["seed"])
    n = {"text": 304, "half": cap // 2, "full": cap}[load]
    return generator.payload(n, 19, 0, 0)


def _judge(img, bits, cfg):
    res = pipeline.encode_array(
        img, bits, EncodeConfig(strategy="block_adaptive",
                                block_size=cfg["block_size"]),
        bits_stored=cfg["bits_stored"], device="cpu")
    dec = pipeline.decode_container(res.container, restore_original=True,
                                    device="cpu")
    return judge.image(block_ref, cfg, img, bits, res.container,
                       dec.payload_bits, dec.original, res.metrics, "cpu")


@pytest.mark.parametrize("h,w,dtype,block,load", CASES,
                         ids=[f"{h}x{w}-{dt}-b{b}-{ld}"
                              for h, w, dt, b, ld in CASES])
def test_port_agrees_with_the_block_reference(h, w, dtype, block, load):
    img = generator.images(h, w, dtype, BITS_STORED[dtype], 1, 2**31 + h)[0]
    cfg = _cfg(dtype, block)
    out = _judge(img, _payload(img, cfg, load), cfg)
    assert all(out[k] == 0 for k in judge.EXACT), out
    assert 0 <= out["metric_gap"] < 1e-4


def _tied_image():
    """64x64 u8 noise whose bit 0 is a checkerboard: every tile of plane 0
    holds 32 ones of 64, so all 64 tiles tie there."""
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (64, 64)).astype(np.uint8)
    y, x = np.mgrid[0:64, 0:64]
    return (img & 0xFE) | ((y + x) & 1).astype(np.uint8)


def test_reverse_raster_ties_are_caught(monkeypatch):
    img = _tied_image()
    cfg = _cfg("uint8", 8)
    bits = generator.payload(304, 23, 0, 0)
    assert all(v == 0 for k, v in _judge(img, bits, cfg).items()
               if k in judge.EXACT)

    def reverse_ties(keys):
        return sorted(range(len(keys)), key=lambda t: (-keys[t], -t))

    monkeypatch.setattr(block_ref, "tile_order", reverse_ties)
    out = _judge(img, bits, cfg)
    assert out["stego_px"] > 0 or out["payload_bits"] > 0, out


def test_block_decode_with_a_payload_bit_altered_is_caught(monkeypatch):
    """The decode reads the payload through ``extract_block_message_device``;
    a bit flipped there is a payload bit the judge counts."""
    from codec_tcc_tpu_torch.ops import embed as embed_ops

    real = embed_ops.extract_block_message_device

    def flipped(*a, **k):
        bits = real(*a, **k).clone()
        bits[0] ^= 1
        return bits

    monkeypatch.setattr(embed_ops, "extract_block_message_device", flipped)
    img = generator.images(64, 64, "uint16", 12, 1, 2**31 + 64)[0]
    cfg = _cfg("uint16", 8)
    out = _judge(img, _payload(img, cfg, "half"), cfg)
    assert out["payload_bits"] > 0, out
    assert out["stego_px"] == 0 and out["restored_px"] == 0, out


def test_spans_and_counters_of_the_block_fill():
    img = generator.images(64, 64, "uint16", 12, 1, 2**31 + 7)[0]
    cfg = _cfg("uint16", 8)
    s = raster.cut_point(img, cfg["beta"], cfg["bits_stored"])
    bits = _payload(img, cfg, "half")
    prof = profiling.get_profiler()
    prof.reset()
    profiling.enable()
    try:
        res = pipeline.encode_array(img, bits,
                                    EncodeConfig(strategy="block_adaptive"),
                                    bits_stored=12, device="cpu")
        pipeline.decode_container(res.container, device="cpu")
    finally:
        profiling.disable()
    c = profiling.counters()
    assert res.s == s
    assert c["block.tiles_ranked"] == 2 * s * 64
    assert c["block.bits_placed"] == 2 * bits.size
    assert prof.calls["block_rank"] == 2 and prof.calls["restore"] == 1
    names = {sp.span_id: sp.name for sp in prof.spans}
    parents = sorted(names[sp.parent_id] for sp in prof.spans
                     if sp.name == "block_rank")
    assert parents == ["embed", "extract"]
    restore = next(sp for sp in prof.spans if sp.name == "restore")
    assert names[restore.parent_id] == "decode_container"
    prof.reset()


@pytest.mark.parametrize("lowered", [False, True], ids=["same-max",
                                                        "max-lowered"])
def test_encode_report_routes_as_analyze_pair(lowered):
    """The encodes' report: the moments where the maxima agree, the float64
    normalisation branch where the payload lowered the one maximum pixel
    (the case the 61x67 u16 full payload above hits)."""
    from codec_tcc_tpu_torch.ops import metrics

    img = generator.images(61, 67, "uint16", 12, 1, 3)[0].copy()
    img.flat[0] = 4095
    stego = img ^ (np.arange(img.size, dtype=np.uint16).reshape(img.shape)
                   & 1)
    stego[stego == 4095] = 4095 - lowered
    stats = {k: v.numpy() for k, v in metrics.pair_stats(
        torch.from_numpy(img), torch.from_numpy(stego)).items()}
    got = metrics.encode_report(stats, img, stego)
    assert judge.metric_gap(got, raster.quality(img, stego)) < 1e-5
    assert got == (metrics.host_pair_report(img, stego) if lowered
                   else metrics.quality_report(stats))
