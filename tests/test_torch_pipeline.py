"""The port's encode/decode pipeline (on the CPU, through the kernels' plain
versions) against the JAX package's: containers byte-identical, each side
decoding the other's, the committed goldens and parity hashes, strategies
``block_adaptive`` and ``pee`` and the host embed route through the same
entry points, and the requests that are not yet ported."""

import os

import numpy as np
import pytest
import torch

import codec_tcc_tpu as jax_pkg
import codec_tcc_tpu_torch as port
from codec_tcc_tpu.ops.segments import usable_capacity_bits
from codec_tcc_tpu_torch.io import container as port_container
from codec_tcc_tpu_torch.ops import raster_kernels

import torch_port_cases as cases

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "data")
TEXT = cases.TEXT_PAYLOAD


def _image(h, w, dtype, seed=0):
    rng = np.random.default_rng(seed)
    hi = 255 if dtype == np.uint8 else 4095
    y, x = np.mgrid[0:h, 0:w]
    base = (x * 3 + y) / (3 * w + h) * hi * 0.8
    return np.clip(base + rng.normal(0, hi * 0.02, (h, w)), 0, hi).astype(dtype)


def _payload(kind, img, bits_stored):
    if kind == "text":
        return np.unpackbits(np.frombuffer(TEXT.encode(), np.uint8))
    s = jax_pkg.encode_array(img, b"", bits_stored=bits_stored).s
    cap = usable_capacity_bits(s, img.size, 42)
    return np.random.default_rng(1).integers(0, 2, cap, dtype=np.uint8)


@pytest.mark.parametrize("payload", ["text", "capacity"])
@pytest.mark.parametrize("h,w", [(64, 64), (37, 53)])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("strategy", ["hybrid", "multi_plane"])
def test_encode_byte_identical_and_cross_decode(strategy, dtype, h, w, payload):
    bits_stored = 8 if dtype == np.uint8 else 12
    img = _image(h, w, dtype)
    bits = _payload(payload, img, bits_stored)
    res_p = port.encode_array(img, bits, port.EncodeConfig(strategy=strategy),
                              bits_stored=bits_stored, device="cpu")
    res_j = jax_pkg.encode_array(img, bits,
                                 jax_pkg.EncodeConfig(strategy=strategy),
                                 bits_stored=bits_stored)
    assert res_p.container == res_j.container
    np.testing.assert_array_equal(res_p.stego, res_j.stego)
    assert res_p.s == res_j.s
    assert res_p.metrics["changed_pixels"] == res_j.metrics["changed_pixels"]
    assert res_p.meta.bitmaps_packed == ((h * w) % 8 == 0)

    dec_p = port.decode_container(res_j.container, device="cpu")
    dec_j = jax_pkg.decode_container(res_p.container)
    for dec in (dec_p, dec_j):
        np.testing.assert_array_equal(dec.payload_bits, bits)
        np.testing.assert_array_equal(dec.stego, res_j.stego)
        np.testing.assert_array_equal(dec.original, img)


def test_capacity_error_one_bit_over():
    img = _image(64, 64, np.uint16)
    s = port.encode_array(img, b"", bits_stored=12, device="cpu").s
    cap = usable_capacity_bits(s, img.size, 42)
    bits = np.ones(cap + 1, np.uint8)
    with pytest.raises(port.CapacityError):
        port.encode_array(img, bits, bits_stored=12, device="cpu")
    with pytest.raises(jax_pkg.CapacityError):
        jax_pkg.encode_array(img, bits, bits_stored=12)


@pytest.mark.parametrize("name", ["hybrid", "hybrid_packed", "multi_plane"])
def test_golden_raster_containers_decode(name):
    img = np.load(os.path.join(DATA, "golden_image.npy"))
    with open(os.path.join(DATA, "golden_payload.bin"), "rb") as f:
        payload = f.read()
    with open(os.path.join(DATA, f"golden_{name}.stgc"), "rb") as f:
        blob = f.read()
    dec = port.decode_container(blob, device="cpu")
    assert dec.payload == payload
    np.testing.assert_array_equal(dec.original, img)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_pee_encodes_on_the_port(dtype):
    bits_stored = 8 if dtype == np.uint8 else 12
    img = _image(40, 36, dtype)
    cfg = dict(strategy="pee")
    res_p = port.encode_array(img, TEXT, port.EncodeConfig(**cfg),
                              bits_stored=bits_stored, device="cpu")
    res_j = jax_pkg.encode_array(img, TEXT, jax_pkg.EncodeConfig(**cfg),
                                 bits_stored=bits_stored)
    assert res_p.container == res_j.container
    assert res_p.meta.strategy == "pee" and res_p.s == 0
    dec = port.decode_container(res_p.container, device="cpu")
    assert dec.message == TEXT
    np.testing.assert_array_equal(dec.original, img)


def test_golden_pee_container_decodes():
    img = np.load(os.path.join(DATA, "golden_pee_image.npy"))
    with open(os.path.join(DATA, "golden_payload.bin"), "rb") as f:
        payload = f.read()
    with open(os.path.join(DATA, "golden_pee.stgc"), "rb") as f:
        dec = port.decode_container(f.read(), device="cpu")
    assert dec.meta.strategy == "pee"
    assert dec.payload == payload
    np.testing.assert_array_equal(dec.original, img)


@pytest.mark.parametrize("name", ["mr512_u16", "ot512_u8", "blk_mr512_u16",
                                  "blk_odd500x501_u8",
                                  "blk_odd640x480_u16_b12", "host_mr512_u16",
                                  "host_odd640x480_u16"])
def test_parity_fixture_regenerates(name):
    """Both packages reproduce the committed hashes the GPU run checks."""
    case = cases.BY_NAME[name]
    want = cases.load_parity()[name]
    img = cases.image(case)
    bits = cases.payload_bits(case, 0)
    assert cases.sha256(bits) == want["payload_sha256"]
    res_j = jax_pkg.encode_array(
        img, bits, case.config(jax_pkg.EncodeConfig),
        bits_stored=case.bits_stored)
    res_p = port.encode_array(
        img, bits, case.config(port.EncodeConfig),
        bits_stored=case.bits_stored, device="cpu")
    for res in (res_j, res_p):
        assert res.s == want["s"]
        assert len(res.container) == want["container_len"]
        assert cases.sha256(res.container) == want["container_sha256"]


def test_encode_counts_no_kernel_launch_on_cpu():
    raster_kernels.reset_launch_counts()
    res = port.encode_array(_image(32, 32, np.uint16), TEXT, bits_stored=12,
                            device="cpu")
    port.decode_container(res.container, device="cpu")
    assert set(raster_kernels.LAUNCHES.values()) == {0}


def test_cuda_default_raises_without_gpu():
    """No entry point falls back to the CPU: the default device is cuda."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; this checks the no-GPU refusal")
    img = _image(32, 32, np.uint16)
    with pytest.raises(RuntimeError, match="cuda"):
        port.encode_array(img, TEXT)
    blob = jax_pkg.encode_array(img, TEXT).container
    with pytest.raises(RuntimeError, match="cuda"):
        port.decode_container(blob)


@pytest.mark.parametrize("overrides,item", [
    ({"container_version": 1}, "v1 containers"),
    ({"codec": "png"}, "other codecs"),
    ({"strategy": "pee", "codec": "png"}, "other codecs"),
], ids=["v1", "png", "pee_png"])
def test_unported_encode_requests_raise(overrides, item):
    img = _image(32, 32, np.uint16)
    with pytest.raises(NotImplementedError, match=item):
        port.encode_array(img, TEXT, port.EncodeConfig(**overrides),
                          device="cpu")


def test_device_policy_device_without_metrics_is_ported():
    img = _image(32, 32, np.uint16)
    cfg = dict(compute_metrics=False, device_policy="device")
    res_p = port.encode_array(img, TEXT, port.EncodeConfig(**cfg), device="cpu")
    res_j = jax_pkg.encode_array(img, TEXT, jax_pkg.EncodeConfig(**cfg))
    assert res_p.metrics is None
    assert res_p.container == res_j.container


def _cross_decode(img, payload, cfg, bits_stored):
    """Both packages encode ``img``: containers byte-identical; each decodes
    the other's to the payload and the original."""
    res_p = port.encode_array(img, payload, port.EncodeConfig(**cfg),
                              bits_stored=bits_stored, device="cpu")
    res_j = jax_pkg.encode_array(img, payload, jax_pkg.EncodeConfig(**cfg),
                                 bits_stored=bits_stored)
    assert res_p.container == res_j.container
    np.testing.assert_array_equal(res_p.stego, res_j.stego)
    dec_p = port.decode_container(res_j.container, device="cpu")
    dec_j = jax_pkg.decode_container(res_p.container)
    for dec in (dec_p, dec_j):
        np.testing.assert_array_equal(dec.payload_bits, payload)
        np.testing.assert_array_equal(dec.stego, res_j.stego)
        np.testing.assert_array_equal(dec.original, img)
    return res_p


@pytest.mark.parametrize("payload", ["text", "capacity"])
@pytest.mark.parametrize("h,w,block", [(64, 64, 8), (37, 53, 8), (40, 41, 12),
                                       (48, 64, 16)])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_block_adaptive_encodes_as_in_jax(dtype, h, w, block, payload):
    bits_stored = 8 if dtype == np.uint8 else 12
    img = _image(h, w, dtype)
    bits = _payload(payload, img, bits_stored)
    res = _cross_decode(img, bits, dict(strategy="block_adaptive",
                                        block_size=block), bits_stored)
    assert res.meta.strategy == "block_adaptive"
    assert res.meta.bitmaps_packed == ((h * w) % 8 == 0)
    assert port_container.parse_block_ext(res.meta.ext) == block


@pytest.mark.parametrize("strategy", ["hybrid", "multi_plane"])
def test_host_policy_encodes_as_in_jax(strategy):
    img = _image(40, 48, np.uint16)
    res = _cross_decode(img, _payload("capacity", img, 12),
                        dict(strategy=strategy, device_policy="host"), 12)
    assert res.metrics is not None


@pytest.mark.parametrize("strategy", ["hybrid", "multi_plane"])
def test_auto_no_metrics_encodes_as_in_jax(strategy):
    img = _image(32, 32, np.uint8)
    bits = _payload("text", img, 8)
    res = _cross_decode(img, bits, dict(strategy=strategy,
                                        compute_metrics=False), 8)
    assert res.metrics is None


def test_block_adaptive_with_host_policy_raises_as_in_jax():
    img = _image(32, 32, np.uint16)
    cfg = dict(strategy="block_adaptive", device_policy="host")
    with pytest.raises(ValueError, match="device_policy='host'"):
        jax_pkg.encode_array(img, TEXT, jax_pkg.EncodeConfig(**cfg))
    with pytest.raises(ValueError, match="device_policy='host'"):
        port.encode_array(img, TEXT, port.EncodeConfig(**cfg), device="cpu")


def test_golden_block_adaptive_container_decodes():
    img = np.load(os.path.join(DATA, "golden_image.npy"))
    with open(os.path.join(DATA, "golden_payload.bin"), "rb") as f:
        payload = f.read()
    with open(os.path.join(DATA, "golden_block_adaptive.stgc"), "rb") as f:
        dec = port.decode_container(f.read(), device="cpu")
    assert dec.meta.strategy == "block_adaptive"
    assert dec.payload == payload
    np.testing.assert_array_equal(dec.original, img)


def test_block_adaptive_without_maps_raises_on_decode():
    img = _image(32, 32, np.uint16)
    cfg = dict(strategy="block_adaptive", store_bitmaps=False)
    blob = port.encode_array(img, TEXT, port.EncodeConfig(**cfg),
                             device="cpu").container
    assert blob == jax_pkg.encode_array(img, TEXT,
                                        jax_pkg.EncodeConfig(**cfg)).container
    for decode in (jax_pkg.decode_container,
                   lambda b: port.decode_container(b, device="cpu")):
        with pytest.raises(ValueError, match="XOR location maps"):
            decode(blob)


@pytest.mark.parametrize("fixture,item", [
    ("ref_v1_pe.bin", "v1 containers"),
])
def test_unported_containers_raise_on_decode(fixture, item):
    with open(os.path.join(DATA, fixture), "rb") as f:
        blob = f.read()
    with pytest.raises(NotImplementedError, match=item):
        port.decode_container(blob, device="cpu")


def test_unported_codec_container_raises_on_decode():
    img = _image(32, 32, np.uint8)
    cont = port_container.parse(
        port.encode_array(img, TEXT, bits_stored=8, device="cpu").container)
    cont.meta.codec = "png"
    blob = port_container.pack(cont.meta, cont.bitmaps_blob, cont.stego_blob)
    with pytest.raises(NotImplementedError, match="other codecs"):
        port.decode_container(blob, device="cpu")
