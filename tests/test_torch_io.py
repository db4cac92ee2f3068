"""The port's host I/O against the JAX package's: STGC v2/v2.1 containers,
the deflate codec, DICOM files and the bit utilities must produce the same
bytes, and the copied modules must be the same code."""

import dataclasses

import numpy as np
import pytest
import torch

from codec_tcc_tpu import config as jax_config
from codec_tcc_tpu import errors as jax_errors
from codec_tcc_tpu.io import codecs as jax_codecs
from codec_tcc_tpu.io import container as jax_container
from codec_tcc_tpu.io import dicom as jax_dicom
from codec_tcc_tpu.utils import bits as jax_bits
from codec_tcc_tpu.utils import rng as jax_rng
from codec_tcc_tpu_torch import config as torch_config
from codec_tcc_tpu_torch import errors as torch_errors
from codec_tcc_tpu_torch.io import codecs as torch_codecs
from codec_tcc_tpu_torch.io import container as torch_container
from codec_tcc_tpu_torch.io import dicom as torch_dicom
from codec_tcc_tpu_torch.utils import bits as torch_bits
from codec_tcc_tpu_torch.utils import rng as torch_rng

from torch_parity import same_code

torch.set_num_threads(1)


@pytest.mark.parametrize("port,orig", [
    (torch_container, jax_container), (torch_dicom, jax_dicom),
    (torch_bits, jax_bits), (torch_rng, jax_rng),
    (torch_errors, jax_errors), (torch_config, jax_config),
    (torch_codecs.DeflateCodec, jax_codecs.DeflateCodec),
    (torch_codecs.Codec, jax_codecs.Codec),
], ids=["container", "dicom", "bits", "rng", "errors", "config", "deflate",
        "codec_abc"])
def test_copied_module_is_the_same_code(port, orig):
    assert same_code(port, orig)


def _meta(mod, *, packed, dtype, s=3, strategy="hybrid"):
    return mod.ContainerMeta(
        version=2, codec="deflate", strategy=strategy, s=s, nbits=12,
        bits_stored=12, dtype=np.dtype(dtype), width=53, height=40,
        start_offset=1234, seed=42, payload_bits=777,
        align_across_planes=False, has_bitmaps=True, bitmaps_packed=packed,
        sizes=(500, 300, -23)[:s], indices=(2, 0, 1)[:s],
        eff_lengths=(500, 277, 0)[:s], plane_starts=(1234, 1734, 2011)[:s],
        ext=b"",
    )


@pytest.mark.parametrize("packed", [False, True], ids=["v2", "v2.1"])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_container_pack_parse_byte_identical(packed, dtype):
    bitmaps, stego = b"\x01maps" * 7, b"SDFL" + bytes(range(50))
    blob_t = torch_container.pack(_meta(torch_container, packed=packed,
                                        dtype=dtype), bitmaps, stego)
    blob_j = jax_container.pack(_meta(jax_container, packed=packed,
                                      dtype=dtype), bitmaps, stego)
    assert blob_t == blob_j
    ct = torch_container.parse(blob_j)
    cj = jax_container.parse(blob_t)
    assert dataclasses.asdict(ct.meta) == dataclasses.asdict(cj.meta)
    assert (ct.bitmaps_blob, ct.stego_blob) == (cj.bitmaps_blob, cj.stego_blob)


@pytest.mark.parametrize("packed", [False, True], ids=["raw", "packed"])
def test_bitmap_blobs_and_restore_byte_identical(packed):
    rng = np.random.default_rng(2)
    h, w, s = 40, 64, 3
    maps = (rng.random((s, h, w)) < 0.05).astype(np.uint8)
    compress = "compress_bitmaps_packed" if packed else "compress_bitmaps"
    blob_t = getattr(torch_container, compress)(maps)
    assert blob_t == getattr(jax_container, compress)(maps)
    stego = rng.integers(0, 4096, (h, w)).astype(np.uint16)
    meta_t = dataclasses.replace(
        _meta(torch_container, packed=packed, dtype=np.uint16),
        width=w, height=h, strategy="multi_plane",
        plane_starts=(0, 0, 0), eff_lengths=(h * w,) * 3)
    meta_j = jax_container.ContainerMeta(**dataclasses.asdict(meta_t))
    ct = torch_container.Container(meta_t, blob_t, b"")
    cj = jax_container.Container(meta_j, blob_t, b"")
    np.testing.assert_array_equal(ct.diff(np.uint16), cj.diff(np.uint16))
    np.testing.assert_array_equal(ct.restore_original(stego),
                                  cj.restore_original(stego))


@pytest.mark.parametrize("shape", [(64, 64), (37, 53)])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_deflate_codec_byte_identical(shape, dtype):
    rng = np.random.default_rng(3)
    hi = 256 if dtype == np.uint8 else 4096
    img = rng.integers(0, hi, shape).astype(dtype)
    blob_t = torch_codecs.get("deflate").encode(img)
    blob_j = jax_codecs.get("deflate").encode(img)
    assert blob_t == blob_j
    out = torch_codecs.get("deflate").decode(blob_j)
    assert out.dtype == img.dtype
    np.testing.assert_array_equal(out, img)


def test_codec_registry_names_and_unported_codecs():
    assert torch_codecs.names() == jax_codecs.names()
    assert torch_codecs.available_names() == ["deflate"]
    assert torch_codecs.by_id(5).name == jax_codecs.by_id(5).name == "deflate"
    for cid, name in {1: "png", 2: "j2k", 3: "jls", 4: "jxl"}.items():
        codec = torch_codecs.by_id(cid)
        assert codec.name == jax_codecs.by_id(cid).name == name
        assert not codec.available()
        with pytest.raises(RuntimeError, match="unavailable"):
            torch_codecs.get(name)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            codec.encode(np.zeros((2, 2), np.uint8))
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            codec.decode(b"")
    with pytest.raises(ValueError, match="not supported"):
        torch_codecs.get("nope")


@pytest.mark.parametrize("deflated", [False, True])
@pytest.mark.parametrize("dtype,bits", [(np.uint8, 8), (np.uint16, 12)])
def test_dicom_written_by_port_reads_back_in_both_readers(deflated, dtype, bits):
    rng = np.random.default_rng(4)
    img = rng.integers(0, 1 << bits, (37, 53)).astype(dtype)
    data = torch_dicom.to_bytes(
        torch_dicom.build_secondary_capture(img, bits_stored=bits),
        deflated=deflated,
    )
    for reader in (torch_dicom, jax_dicom):
        ds = reader.read_bytes(data)
        assert ds.bits_stored == bits
        np.testing.assert_array_equal(ds.pixel_array, img)


def test_bit_utils_match_jax():
    rng = np.random.default_rng(5)
    payload = rng.integers(0, 256, 97, dtype=np.uint8).tobytes()
    np.testing.assert_array_equal(torch_bits.bytes_to_bits(payload),
                                  jax_bits.bytes_to_bits(payload))
    bits = jax_bits.bytes_to_bits(payload)
    assert torch_bits.bits_to_bytes(bits[:-3]) == jax_bits.bits_to_bytes(bits[:-3])
    n = 4096
    for start, ln in [(0, 0), (10, 100), (n - 5, 40), (n // 2, n), (n + 3, 9)]:
        assert torch_bits.raster_window_spans(start, ln, n) == (
            jax_bits.raster_window_spans(start, ln, n))
    packed = (rng.random((3, n // 8)) < 0.2).astype(np.uint8) * rng.integers(
        0, 256, (3, n // 8)).astype(np.uint8)
    np.testing.assert_array_equal(torch_bits.expand_bits(packed),
                                  jax_bits.expand_bits(packed))
    np.testing.assert_array_equal(
        torch_bits.packed_planes_to_diff(packed, np.uint16),
        jax_bits.packed_planes_to_diff(packed, np.uint16))
    img = rng.integers(0, 4096, (32, 128)).astype(np.uint16)
    starts, lens = [n - 20, 7, 100], [300, n, 0]
    np.testing.assert_array_equal(
        torch_bits.xor_packed_windows(img, packed, starts, lens),
        jax_bits.xor_packed_windows(img, packed, starts, lens))
