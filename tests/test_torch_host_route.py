"""The host embed route in the port against the JAX package, on the CPU:
``device_policy="host"``, and ``"auto"`` with ``compute_metrics=False``,
place a raster payload with numpy windows (``ops/host_embed.py``) and give
the JAX package's container bytes, which are also the device route's. The
route and the exceptions follow the JAX package's ``resolve_host_route``
over a grid of configurations."""

import numpy as np
import pytest
import torch

import codec_tcc_tpu as jax_pkg
from codec_tcc_tpu.ops import host_embed as jax_host_embed
from codec_tcc_tpu.ops.segments import usable_capacity_bits
from codec_tcc_tpu.parallel import batch as jax_batch
from codec_tcc_tpu_torch import profiling
import codec_tcc_tpu_torch as port
from codec_tcc_tpu_torch import pipeline as port_pipeline
from codec_tcc_tpu_torch.ops import blocks as block_ops
from codec_tcc_tpu_torch.ops.decompose import decompose
from codec_tcc_tpu_torch.ops import raster_kernels
from codec_tcc_tpu_torch.parallel import batch as torch_batch

import torch_port_cases as cases
from test_torch_ops import MOMENT_RTOL

torch.set_num_threads(1)

TEXT = cases.TEXT_PAYLOAD


def _image(h, w, dtype, seed=0):
    rng = np.random.default_rng(seed)
    hi = 255 if dtype == np.uint8 else 4095
    y, x = np.mgrid[0:h, 0:w]
    base = (x * 3 + y) / (3 * w + h) * hi * 0.8
    return np.clip(base + rng.normal(0, hi * 0.02, (h, w)), 0, hi).astype(dtype)


def _bits_stored(dtype):
    return 8 if dtype == np.uint8 else 12


def _payload(kind, img):
    if kind == "text":
        return np.unpackbits(np.frombuffer(TEXT.encode(), np.uint8))
    s = decompose(torch.from_numpy(img), 0.4, _bits_stored(img.dtype)).s
    cap = usable_capacity_bits(s, img.size, 42)
    return np.random.default_rng(1).integers(0, 2, cap, dtype=np.uint8)


@pytest.fixture
def spies(monkeypatch):
    """Counts the calls of each package's host embed and of the port's K1
    wrapper, so a test sees which route an encode took."""
    calls = {"jax_host": 0, "port_host": 0, "k1": 0}

    def spy(key, fn):
        def wrapped(*args, **kwargs):
            calls[key] += 1
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(jax_host_embed, "embed_raster_host_packed",
                        spy("jax_host", jax_host_embed.embed_raster_host_packed))
    monkeypatch.setattr(port_pipeline, "embed_raster_host_packed",
                        spy("port_host", port_pipeline.embed_raster_host_packed))
    monkeypatch.setattr(raster_kernels, "raster_embed",
                        spy("k1", raster_kernels.raster_embed))
    return calls


@pytest.mark.parametrize("payload", ["text", "capacity"])
@pytest.mark.parametrize("h,w", [(64, 64), (48, 40), (24, 85)])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("strategy", ["hybrid", "multi_plane"])
def test_host_route_containers_match_jax_and_device_route(
        spies, strategy, dtype, h, w, payload):
    img = _image(h, w, dtype)
    bits = _payload(payload, img)
    bs = _bits_stored(dtype)
    cfg = dict(strategy=strategy, device_policy="host")
    res_j = jax_pkg.encode_array(img, bits, jax_pkg.EncodeConfig(**cfg),
                                 bits_stored=bs)
    res_p = port.encode_array(img, bits, port.EncodeConfig(**cfg),
                              bits_stored=bs, device="cpu")
    assert spies == {"jax_host": 1, "port_host": 1, "k1": 0}
    res_d = port.encode_array(
        img, bits, port.EncodeConfig(strategy=strategy, device_policy="device"),
        bits_stored=bs, device="cpu")
    assert spies["k1"] == 1 and spies["port_host"] == 1
    assert res_p.container == res_j.container == res_d.container
    np.testing.assert_array_equal(res_p.stego, res_j.stego)
    # a forced "host" that asks for metrics still reports them: the same
    # moments as the device route's. Against the JAX package, the exact
    # integer counts, and a moment within MOMENT_RTOL (its mse, psnr and
    # ssim subtract float32 moments near 2e7 where the two images' maxima
    # differ, which magnifies the summation order's rounding)
    assert res_p.metrics == res_d.metrics
    for k in ("changed_pixels", "max_abs_diff", "max_value"):
        assert res_p.metrics[k] == res_j.metrics[k], k
    np.testing.assert_allclose(res_p.metrics["mean_abs_diff"],
                               res_j.metrics["mean_abs_diff"],
                               rtol=MOMENT_RTOL)
    dec_p = port.decode_container(res_j.container, device="cpu")
    dec_j = jax_pkg.decode_container(res_p.container)
    for dec in (dec_p, dec_j):
        np.testing.assert_array_equal(dec.payload_bits, bits)
        np.testing.assert_array_equal(dec.original, img)


@pytest.mark.parametrize("strategy", ["hybrid", "multi_plane"])
def test_auto_without_metrics_takes_the_host_route(spies, strategy):
    img = _image(64, 48, np.uint16, seed=3)
    cfg = dict(strategy=strategy, compute_metrics=False)
    profiling.get_profiler().reset()
    res_p = port.encode_array(img, TEXT, port.EncodeConfig(**cfg),
                              bits_stored=12, device="cpu")
    res_j = jax_pkg.encode_array(img, TEXT, jax_pkg.EncodeConfig(**cfg),
                                 bits_stored=12)
    assert res_p.metrics is None and res_j.metrics is None
    assert res_p.container == res_j.container
    assert spies == {"jax_host": 1, "port_host": 1, "k1": 0}
    assert profiling.launches(raster_kernels.KERNELS)["raster_embed"] == 0
    assert port.decode_container(res_p.container, device="cpu").message == TEXT


GEOMETRIES = {"hw_mod8": (32, 24), "hw_odd": (33, 35)}


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
@pytest.mark.parametrize("metrics", [True, False], ids=["metrics", "no_metrics"])
@pytest.mark.parametrize("policy", ["auto", "device", "host"])
@pytest.mark.parametrize("strategy",
                         ["hybrid", "multi_plane", "block_adaptive", "pee"])
def test_route_and_exceptions_match_jax(spies, strategy, policy, metrics,
                                        geometry):
    """strategy x device_policy x compute_metrics x (H*W % 8 == 0 or not):
    the host route is taken exactly where the JAX package takes it, and a
    configuration the JAX package refuses raises the same exception."""
    img = _image(*GEOMETRIES[geometry], np.uint16, seed=5)
    cfg = dict(strategy=strategy, device_policy=policy,
               compute_metrics=metrics)
    outcome = {}
    for key, pkg, kwargs in (("jax", jax_pkg, {}),
                             ("port", port, {"device": "cpu"})):
        try:
            res = pkg.encode_array(img, TEXT, pkg.EncodeConfig(**cfg),
                                   bits_stored=12, **kwargs)
        except Exception as exc:      # the outcome compared is the exception
            outcome[key] = (type(exc).__name__, str(exc))
        else:
            outcome[key] = res.container
    assert outcome["port"] == outcome["jax"]
    assert spies["port_host"] == spies["jax_host"]
    assert spies["port_host"] + spies["k1"] <= 1
    host_ok = strategy in ("hybrid", "multi_plane") and img.size % 8 == 0
    if strategy != "pee" and (policy == "host"
                              or (policy == "auto" and not metrics)):
        assert spies["port_host"] == int(host_ok)
        if policy == "host" and not host_ok:
            assert outcome["port"][0] == "ValueError"
    else:
        assert spies["port_host"] == 0


@pytest.mark.parametrize("h,w,dtype,block", [
    (64, 64, np.uint16, 16), (37, 53, np.uint8, 16), (512, 512, np.uint16, 16),
    (40, 64, np.uint16, 8), (5, 7, np.uint8, 16)])
def test_hybrid_base_offsets_host_equals_device_scan(h, w, dtype, block):
    rng = np.random.default_rng(h + w)
    hi = 1 << (8 * np.dtype(dtype).itemsize)
    imgs = rng.integers(0, hi, (3, h, w)).astype(dtype)
    host = torch_batch.hybrid_base_offsets_host(imgs, h, w, block)
    device = [block_ops.best_offset_from_counts(
        block_ops.block_bit_counts(torch.from_numpy(img), 0, block).numpy(),
        h, w, block) for img in imgs]
    jax_device = jax_batch.hybrid_base_offsets(imgs, h, w, block)
    assert host == device == list(jax_device)
