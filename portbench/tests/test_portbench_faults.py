"""A run with its timed path broken underneath must come out not
correct: for each fault a cell can have, the harness driven on the CPU at
a small size (its look for a card skipped)."""

import time

import numpy as np
import pytest

from portbench import harness

from .small import SMALL


def run(cell):
    return harness.run_cell(cell, 2**31 + 5, 0.3, False, device="cpu",
                            t0=time.perf_counter(), overrides=SMALL[cell])[0]


def test_embed_that_returns_the_image_unchanged(monkeypatch):
    from codec_tcc_tpu_torch import pipeline

    def unchanged(image_dev, msg_bits, pp, s, emit_maps, with_stats):
        img = image_dev.cpu().numpy()
        packed = np.zeros((s, img.size // 8), np.uint8) if emit_maps else None
        stats = pipeline.metric_ops.pair_stats(image_dev, image_dev)
        return img, packed, stats if with_stats else None

    monkeypatch.setattr(pipeline, "_embed_raster", unchanged)
    assert not run("mr512_hybrid.single")["correct"]


def test_pee_passes_that_return_the_image_unchanged(monkeypatch):
    from codec_tcc_tpu_torch.ops import pee_kernels

    real = pee_kernels.embed_both_passes

    def unchanged(img, msg, total, t, max_val):
        out = real(img, msg, total, t, max_val)
        return (img.clone(),) + tuple(out[1:])

    monkeypatch.setattr(pee_kernels, "embed_both_passes", unchanged)
    assert not run("cr2048_pee.single")["correct"]


def test_half_of_the_batch_left_out(monkeypatch):
    from codec_tcc_tpu_torch.parallel import batch

    real = batch.decode_batch_containers

    def half(containers, *a, **k):
        kept = real(containers[: len(containers) // 2], *a, **k)
        return kept + kept
    monkeypatch.setattr(batch, "decode_batch_containers", half)
    assert not run("mr512_hybrid.batch32")["correct"]


@pytest.mark.parametrize("cell", ["mr512_hybrid.single", "cr2048_pee.single"])
def test_a_payload_bit_altered_where_it_is_produced(cell, monkeypatch):
    from codec_tcc_tpu_torch import pipeline

    real = pipeline.decode_container

    def flipped(*a, **k):
        dec = real(*a, **k)
        dec.payload_bits = dec.payload_bits.copy()
        dec.payload_bits[0] ^= 1
        return dec

    monkeypatch.setattr(pipeline, "decode_container", flipped)
    assert not run(cell)["correct"]


def test_a_volume_answer_altered(monkeypatch):
    from codec_tcc_tpu_torch.parallel import volume

    real = volume.extract_volume

    def flipped(*a, **k):
        bits = real(*a, **k).copy()
        bits[-1] ^= 1
        return bits

    monkeypatch.setattr(volume, "extract_volume", flipped)
    assert not run("mr512_hybrid.volume64")["correct"]


def test_a_request_that_fails(monkeypatch):
    from codec_tcc_tpu_torch import pipeline

    calls = {"n": 0}
    real = pipeline.encode_array

    def fails_once_warm(*a, **k):
        calls["n"] += 1
        if calls["n"] == 3:
            raise RuntimeError("injected")
        return real(*a, **k)

    monkeypatch.setattr(pipeline, "encode_array", fails_once_warm)
    result = run("mr512_hybrid.single")
    assert result["failed"] == 1 and not result["correct"]


def _bfloat16_metrics(module, name, per_image):
    """Wrap the port's encoder ``module.name`` so that its quality metrics
    are the control's: the reference's formulas with bfloat16 moments, on
    the inputs and the port's own stego."""
    from portbench.reference import control

    real = getattr(module, name)

    def narrowed(inputs, *a, **k):
        res = real(inputs, *a, **k)
        if per_image:
            res.metrics = [control.quality(img, st, "cpu")
                           for img, st in zip(inputs, res.stego)]
        else:
            res.metrics = control.quality(inputs, res.stego, "cpu")
        return res
    return narrowed


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_bfloat16_moments_in_the_ports_place(cell, monkeypatch):
    """The control through the harness's own verdict: the port's quality
    metrics replaced by bfloat16 ones make the run not correct, and every
    exact count still reads 0."""
    from codec_tcc_tpu_torch import pipeline
    from codec_tcc_tpu_torch.parallel import batch, volume

    module, name, per_image = {
        "mr512_hybrid.single": (pipeline, "encode_array", False),
        "cr2048_pee.single": (pipeline, "encode_array", False),
        "mr512_hybrid.batch32": (batch, "encode_batch_containers", True),
        "mr512_hybrid.volume64": (volume, "encode_volume", False),
    }[cell]
    monkeypatch.setattr(module, name,
                        _bfloat16_metrics(module, name, per_image))
    result = run(cell)
    checks = result["checks"]
    assert not result["correct"]
    assert checks["metric_gap"]["value"] > checks["metric_gap"]["limit"]
    assert all(c["value"] == 0 for k, c in checks.items()
               if k != "metric_gap"), checks
