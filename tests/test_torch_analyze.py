"""The rest of the volume slice against the JAX package on the CPU:
``pipeline.capacity_report`` (2-D and 3-D), the metrics
(``host_pair_report``, ``analyze_pair``, ``ssim_windowed``), the embedder
models (``get_embedder``), the quality analyzer (``QualityAnalyzer``),
``ops.bitplanes``, and every copy held to its original
(``tests/torch_parity.py``).

Tolerances: ``capacity_report`` is exact (integers); ``host_pair_report``
and the range-normalised branch of ``analyze_pair`` are exact (the same
float64 numpy code); the equal-range branch of ``analyze_pair`` comes from
float32 moments summed in another order than XLA's: rtol 1e-4;
``ssim_windowed`` is float32 box means in another order: rtol 1e-5, atol
1e-6.
"""

import numpy as np
import pytest
import torch

import codec_tcc_tpu as jax_pkg
import codec_tcc_tpu_torch as port_pkg
from codec_tcc_tpu import analyze as jax_analyze
from codec_tcc_tpu import cli as jax_cli
from codec_tcc_tpu import models as jax_models
from codec_tcc_tpu import pipeline as jax_pipeline
from codec_tcc_tpu.models import lsb as jax_lsb
from codec_tcc_tpu.ops import bitplanes as jax_bitplanes
from codec_tcc_tpu.ops import metrics as jax_metrics
from codec_tcc_tpu_torch import analyze as port_analyze
from codec_tcc_tpu_torch import cli as port_cli
from codec_tcc_tpu_torch import models as port_models
from codec_tcc_tpu_torch import pipeline as port_pipeline
from codec_tcc_tpu_torch.io import dicom
from codec_tcc_tpu_torch.models import lsb as port_lsb
from codec_tcc_tpu_torch.ops import bitplanes as port_bitplanes
from codec_tcc_tpu_torch.ops import metrics as port_metrics

from torch_parity import same_code, same_code_but_device

torch.set_num_threads(1)

EQUAL_RANGE_RTOL = 1e-4
SSIM_W_RTOL = 1e-5
SSIM_W_ATOL = 1e-6


def _image(seed, shape, dtype, hi, sigma=3.0):
    rng = np.random.default_rng(seed)
    h, w = shape[-2:]
    y, x = np.mgrid[0:h, 0:w]
    base = hi * (0.25 + 0.45 * x / w + 0.2 * y / h)
    img = base + rng.normal(0, sigma, shape)
    return np.clip(np.rint(img), 0, hi).astype(dtype)


def _pair(seed, shape, dtype, hi, flips=0.3):
    """An image and a stego-like copy with low bits flipped."""
    img = _image(seed, shape, dtype, hi)
    rng = np.random.default_rng(seed + 1)
    flip = (rng.random(shape) < flips).astype(dtype)
    return img, img ^ flip


# ---------------------------------------------------------------------------
# capacity_report
# ---------------------------------------------------------------------------


CAPACITY_INPUTS = {
    "u16_2d": (lambda: _image(1, (48, 40), np.uint16, 4095), 12),
    "u8_2d_odd": (lambda: _image(2, (33, 35), np.uint8, 255), None),
    "u16_3d": (lambda: _image(3, (3, 24, 40), np.uint16, 4095), None),
    "u8_3d_odd": (lambda: _image(4, (3, 17, 19), np.uint8, 255), None),
}
CAPACITY_OPTIONS = {
    "default": {},
    "nbits_t3": {"nbits": 6, "pee_threshold": 3, "beta": 0.6},
    "ignore_bits_stored": {"use_bits_stored": False, "seed": 7},
}


@pytest.mark.parametrize("opts", CAPACITY_OPTIONS, ids=list(CAPACITY_OPTIONS))
@pytest.mark.parametrize("name", CAPACITY_INPUTS, ids=list(CAPACITY_INPUTS))
def test_capacity_report_equals_jax(name, opts):
    make, bits_stored = CAPACITY_INPUTS[name]
    arr = make()
    kw = dict(bits_stored=bits_stored, **CAPACITY_OPTIONS[opts])
    want = jax_pipeline.capacity_report(arr, **kw)
    got = port_pipeline.capacity_report(arr, device="cpu", **kw)
    assert got == want


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ranges", [None, (255.0, 4095.0), (4095.0, 4095.0)],
                         ids=["data", "differ", "equal"])
@pytest.mark.parametrize("dtype,hi", [(np.uint8, 255), (np.uint16, 4095)],
                         ids=["u8", "u16"])
def test_host_pair_report_is_exact(dtype, hi, ranges):
    a, b = _pair(10, (40, 52), dtype, hi)
    b[0, 0] = 0 if b.max() == a.max() else b[0, 0]   # maxima may differ
    kw = {} if ranges is None else {"range_a": ranges[0],
                                    "range_b": ranges[1]}
    got = port_metrics.host_pair_report(a, b, **kw)
    assert got == jax_metrics.host_pair_report(a, b, **kw)


ANALYZE_PAIRS = {
    # equal data maxima: the fused moments
    "u16_equal": (lambda: _pair(20, (48, 40), np.uint16, 4095), {}),
    "u8_equal_odd": (lambda: _pair(21, (33, 35), np.uint8, 255), {}),
    "u16_equal_3d": (lambda: _pair(22, (3, 24, 40), np.uint16, 4095), {}),
    "u16_ranges_equal": (lambda: _pair(23, (48, 40), np.uint16, 4095),
                         {"range_a": 4095.0, "range_b": 4095.0,
                          "max_value": 65535.0}),
    # differing ranges: the float64 host branch
    "u16_ranges_differ": (lambda: _pair(24, (48, 40), np.uint16, 4095),
                          {"range_a": 4095.0, "range_b": 65535.0}),
    "u8_data_differ": (lambda: (_image(25, (33, 35), np.uint8, 200),
                                _image(26, (33, 35), np.uint8, 255)), {}),
}


@pytest.mark.parametrize("name", ANALYZE_PAIRS, ids=list(ANALYZE_PAIRS))
def test_analyze_pair_matches_jax(name):
    make, kw = ANALYZE_PAIRS[name]
    a, b = make()
    want = jax_pipeline.analyze_pair(a, b, **kw)
    got = port_pipeline.analyze_pair(a, b, device="cpu", **kw)
    assert got.keys() == want.keys()
    differ = ("differ" in name)
    if differ:
        assert got == want          # the same float64 host code
        return
    for k in ("changed_pixels", "max_abs_diff", "max_value"):
        assert got[k] == want[k], k
    for k in ("mse", "psnr", "ssim", "mean_abs_diff", "changed_percent"):
        np.testing.assert_allclose(got[k], want[k], rtol=EQUAL_RANGE_RTOL,
                                   err_msg=k)


def test_analyze_pair_takes_the_host_branch_when_ranges_differ():
    a, b = _pair(27, (48, 40), np.uint16, 4095)
    got = port_metrics.analyze_pair(a, b, range_a=4095.0, range_b=65535.0,
                                    device="cpu")
    assert got == port_metrics.host_pair_report(a, b, range_a=4095.0,
                                                range_b=65535.0)


@pytest.mark.parametrize("window", [8, 7])
@pytest.mark.parametrize("dtype,hi,shape", [
    (np.uint8, 255, (64, 64)), (np.uint16, 4095, (37, 45)),
    (np.uint16, 65535, (48, 40)),
], ids=["u8", "u16_odd", "u16_full"])
def test_ssim_windowed_matches_jax(dtype, hi, shape, window):
    a, b = _pair(30, shape, dtype, hi, flips=0.5)
    mv = float(max(a.max(), b.max()))
    want = float(jax_metrics.ssim_windowed(a, b, mv, window))
    got = float(port_metrics.ssim_windowed(a, b, mv, window, device="cpu"))
    np.testing.assert_allclose(got, want, rtol=SSIM_W_RTOL, atol=SSIM_W_ATOL)
    same = float(port_metrics.ssim_windowed(a, a, mv, window, device="cpu"))
    assert same == pytest.approx(1.0, abs=1e-6)


# ---------------------------------------------------------------------------
# embedder models
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("strategy", ["multi_plane", "block_adaptive",
                                      "hybrid", "pee"])
def test_get_embedder_matches_jax(strategy):
    img = _image(40, (48, 40), np.uint16, 4095)
    kw = {"beta": 0.5, "pee_threshold": 3}
    jm = jax_models.get_embedder(strategy, **kw)
    pm = port_models.get_embedder(strategy, device="cpu", **kw)
    assert type(pm).__name__ == type(jm).__name__
    assert pm.strategy == jm.strategy == strategy and pm.device == "cpu"
    assert pm.config.beta == 0.5 and pm.config.pee_threshold == 3
    for bs in (None, 12):
        assert (pm.capacity_bits(img, bits_stored=bs)
                == jm.capacity_bits(img, bits_stored=bs))
    jres = jm.encode(img, "embedder", bits_stored=12)
    pres = pm.encode(img, "embedder", bits_stored=12)
    assert pres.container == jres.container
    dec = pm.decode(pres.container)
    assert dec.message == "embedder"
    np.testing.assert_array_equal(dec.original, img)


def test_get_embedder_unknown_raises_jax_message():
    with pytest.raises(ValueError) as want:
        jax_models.get_embedder("nope")
    with pytest.raises(ValueError) as got:
        port_models.get_embedder("nope")
    assert str(got.value) == str(want.value)


def test_package_exports_match_jax():
    assert port_pkg.QualityAnalyzer is port_analyze.QualityAnalyzer
    assert port_pkg.get_embedder is port_models.get_embedder
    assert port_pkg.analyze_pair is port_pipeline.analyze_pair
    assert set(jax_pkg.__all__) == set(port_pkg.__all__)


# ---------------------------------------------------------------------------
# QualityAnalyzer
# ---------------------------------------------------------------------------


def _pair_files(tmp_path):
    """(original, stego, name) triples: two DICOM pairs (BitsStored 12 for
    both; 12 against 16: the normalised branch) and one array pair."""
    a1, b1 = _pair(50, (48, 40), np.uint16, 4095)
    a2, b2 = _pair(51, (40, 40), np.uint16, 4095)
    paths = {}
    for name, arr, bs in (("o1", a1, 12), ("s1", b1, 12), ("o2", a2, 12),
                          ("s2", b2, 16)):
        paths[name] = str(tmp_path / f"{name}.dcm")
        dicom.save_image(arr, paths[name], bits_stored=bs)
    a3, b3 = _pair(52, (33, 35), np.uint8, 255)
    return [(paths["o1"], paths["s1"], "p1"), (paths["o2"], paths["s2"], "p2"),
            (a3, b3, "p3")]


@pytest.mark.parametrize("windowed", [False, True])
def test_quality_analyzer_matches_jax(tmp_path, windowed):
    triples = _pair_files(tmp_path)
    ja = jax_analyze.QualityAnalyzer(windowed_ssim=windowed)
    pa = port_analyze.QualityAnalyzer(windowed_ssim=windowed, device="cpu")
    jres = ja.analyze_pairs(triples)
    pres = pa.analyze_pairs(triples)
    assert [r.name for r in pres] == [r.name for r in jres]
    for got, want in zip(pres, jres):
        assert (got.verdict_quality, got.verdict_structure) == (
            want.verdict_quality, want.verdict_structure)
        for k in want.metrics:
            np.testing.assert_allclose(got.metrics[k], want.metrics[k],
                                       rtol=EQUAL_RANGE_RTOL, err_msg=k)
        if windowed:
            np.testing.assert_allclose(got.ssim_windowed, want.ssim_windowed,
                                       rtol=SSIM_W_RTOL, atol=SSIM_W_ATOL)
        else:
            assert got.ssim_windowed is None
    # the normalised DICOM pair takes the float64 host branch: exact
    assert pres[1].metrics == jres[1].metrics
    js, ps = ja.summary(), pa.summary()
    assert ps.keys() == js.keys()
    for k in js:
        np.testing.assert_allclose(ps[k], js[k], rtol=EQUAL_RANGE_RTOL,
                                   err_msg=k)
    rep = pa.report(str(tmp_path / "r.json"))
    assert [p["name"] for p in rep["pairs"]] == ["p1", "p2", "p3"]
    assert ("ssim_windowed" in rep["pairs"][0]) == windowed


def test_quality_analyzer_empty_summary_raises():
    with pytest.raises(ValueError, match="no analyses"):
        port_analyze.QualityAnalyzer(device="cpu").summary()


def test_load_image_matches_jax(tmp_path):
    vol = _image(60, (2, 24, 20), np.uint16, 4095)
    path = str(tmp_path / "mf.dcm")
    dicom.save_image(vol, path, bits_stored=12)
    got, want = port_analyze.load_image(path), jax_analyze.load_image(path)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:] == (4095.0, 12)
    arr = vol[0]
    assert port_analyze.load_image(arr)[1:] == jax_analyze.load_image(arr)[1:]


# ---------------------------------------------------------------------------
# bitplanes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype,hi,nbits", [(np.uint8, 255, 8),
                                            (np.uint16, 4095, 12),
                                            (np.uint16, 65535, 16)])
def test_bitplanes_match_jax(dtype, hi, nbits):
    img = _image(70, (20, 24), dtype, hi, sigma=200)
    planes = port_bitplanes.split_planes(torch.from_numpy(img), nbits)
    want = np.asarray(jax_bitplanes.split_planes(img, nbits))
    np.testing.assert_array_equal(planes.numpy(), want)
    merged = port_bitplanes.merge_planes(planes, nbits)
    jmerged = np.asarray(jax_bitplanes.merge_planes(want, nbits))
    assert merged.numpy().dtype == jmerged.dtype
    np.testing.assert_array_equal(merged.numpy(), jmerged)
    local = np.random.default_rng(1).integers(0, 2, want.shape).astype(
        np.uint8)
    for s in (0, 3, nbits):
        got = port_bitplanes.merge_local_global(
            torch.from_numpy(img), torch.from_numpy(local), s)
        np.testing.assert_array_equal(
            got.numpy(),
            np.asarray(jax_bitplanes.merge_local_global(img, local,
                                                        np.int32(s))))


# ---------------------------------------------------------------------------
# copies
# ---------------------------------------------------------------------------


SAME_CODE = [
    (port_analyze.PairResult, jax_analyze.PairResult),
    (port_analyze.load_image, jax_analyze.load_image),
    (port_analyze._verdicts, jax_analyze._verdicts),
    (port_metrics.host_pair_report, jax_metrics.host_pair_report),
    (port_metrics.quality_report, jax_metrics.quality_report),
    (port_metrics.psnr_from_mse, jax_metrics.psnr_from_mse),
    (port_pipeline.load_input, jax_pipeline.load_input),
    (port_lsb.get_embedder, jax_lsb.get_embedder),
    (port_lsb.MultiPlaneEmbedder, jax_lsb.MultiPlaneEmbedder),
    (port_lsb.BlockAdaptiveEmbedder, jax_lsb.BlockAdaptiveEmbedder),
    (port_lsb.HybridEmbedder, jax_lsb.HybridEmbedder),
]
SAME_BUT_DEVICE = [
    (port_analyze.QualityAnalyzer, jax_analyze.QualityAnalyzer),
    (port_pipeline.analyze_pair, jax_pipeline.analyze_pair),
    (port_lsb.Embedder.__init__, jax_lsb.Embedder.__init__),
    (port_lsb.Embedder.encode, jax_lsb.Embedder.encode),
    (port_lsb.Embedder.encode_dicom, jax_lsb.Embedder.encode_dicom),
    (port_lsb.Embedder.decode, jax_lsb.Embedder.decode),
    (port_lsb.PeeEmbedder.capacity_bits, jax_lsb.PeeEmbedder.capacity_bits),
    (port_cli.cmd_capacity, jax_cli.cmd_capacity),
    (port_cli.cmd_analyze, jax_cli.cmd_analyze),
    (port_cli.cmd_analyze_batch, jax_cli.cmd_analyze_batch),
    (port_cli.cmd_demo, jax_cli.cmd_demo),
    (port_cli.cmd_encode_volume, jax_cli.cmd_encode_volume),
    (port_cli.cmd_decode_volume, jax_cli.cmd_decode_volume),
]


@pytest.mark.parametrize("port_obj,jax_obj", SAME_CODE,
                         ids=[p.__qualname__ for p, _ in SAME_CODE])
def test_copies_are_the_jax_code(port_obj, jax_obj):
    assert same_code(port_obj, jax_obj)


@pytest.mark.parametrize("port_obj,jax_obj", SAME_BUT_DEVICE,
                         ids=[p.__qualname__ for p, _ in SAME_BUT_DEVICE])
def test_copies_are_the_jax_code_but_for_device(port_obj, jax_obj):
    assert same_code_but_device(port_obj, jax_obj)
