"""The port's codec stages (``codec_tcc_tpu_torch.ops.callback_codec``)
against the JAX package's host-callback stages on the CPU: round trips
through ``deflate``, ``jls`` and (where Pillow exists) ``png``; the same
``ValueError`` for a blob over the buffer's capacity and for a decoded
shape that does not match; the copied host halves held to their originals
(``tests/torch_parity.py``); and the embed -> compress -> decompress ->
extract flow on a seeded phantom, bit for bit the JAX package's jitted
flow of ``tests/test_callback_codec.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from codec_tcc_tpu.ops import callback_codec as jax_cc
from codec_tcc_tpu.ops import embed as jax_embed
from codec_tcc_tpu.ops import segments as segment_ops
from codec_tcc_tpu_torch.io import codecs as port_codecs
from codec_tcc_tpu_torch.ops import callback_codec as port_cc
from codec_tcc_tpu_torch.ops import embed as port_embed

import torch_port_cases as cases
from torch_native import build_native_once
from torch_parity import same_code

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def native_built():
    build_native_once(with_jax=True)


def _image(seed=7, h=64, w=64):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 4096, size=(h, w)).astype(np.uint16)


@pytest.mark.parametrize("port_obj,jax_obj", [
    (port_cc._encode_host, jax_cc._encode_host),
    (port_cc._decode_host, jax_cc._decode_host),
], ids=["_encode_host", "_decode_host"])
def test_host_halves_are_the_jax_code(port_obj, jax_obj):
    assert same_code(port_obj, jax_obj)


@pytest.mark.parametrize("codec", ["deflate", "jls", "png"])
def test_roundtrip_matches_jax(codec):
    if codec not in port_codecs.available_names():
        pytest.skip(f"{codec} is unavailable on this host (Pillow)")
    img = _image()
    t = torch.from_numpy(img)
    buf, n = port_cc.compress_stage(t, codec, 1 << 16)
    assert buf.shape == (1 << 16,) and buf.dtype == torch.uint8
    assert n.shape == () and n.dtype == torch.int32
    assert buf.device == n.device == t.device
    want_buf, want_n = jax_cc._encode_host(codec, 1 << 16, img)
    np.testing.assert_array_equal(buf.numpy(), want_buf)
    assert int(n) == int(want_n)
    out = port_cc.decompress_stage(buf, n, codec, img.shape, t.dtype)
    assert out.dtype == torch.uint16 and out.device == buf.device
    np.testing.assert_array_equal(out.numpy(), img)
    np.testing.assert_array_equal(
        port_cc.roundtrip_in_jit(t, codec, 1 << 16).numpy(), img)
    np.testing.assert_array_equal(
        np.asarray(jax_cc.roundtrip_in_jit(img, codec, capacity=1 << 16)),
        img)


def test_capacity_overflow_and_wrong_shape_raise_jax_value_error():
    img = np.random.default_rng(1).integers(0, 65536, (64, 64)).astype(
        np.uint16)                                   # incompressible
    with pytest.raises(ValueError) as want:
        jax_cc._encode_host("deflate", 16, img)
    with pytest.raises(ValueError) as got:
        port_cc.roundtrip_in_jit(torch.from_numpy(img), "deflate", 16)
    assert str(got.value) == str(want.value)
    assert "exceeds the reserved callback buffer" in str(got.value)

    buf, n = port_cc.compress_stage(torch.from_numpy(img), "deflate", 1 << 16)
    with pytest.raises(ValueError) as want:
        jax_cc._decode_host("deflate", (32, 128), np.uint16, buf.numpy(),
                            n.numpy())
    with pytest.raises(ValueError) as got:
        port_cc.decompress_stage(buf, n, "deflate", (32, 128), np.uint16)
    assert str(got.value) == str(want.value)


def test_embed_compress_decode_extract_matches_jax_flow():
    """The flow of ``tests/test_callback_codec.py`` (BASELINE config[4]'s
    cut point and plane count, ``deflate``) on a seeded 512x512 uint16
    phantom instead of a reference DICOM: the JAX package's jitted graph
    and the port's stages give the same stego round trip, aligned rows and
    payload."""
    img = cases.image(cases.BY_NAME["mr512_u16"])
    payload = np.random.default_rng(2000).integers(0, 2, 2000).astype(
        np.uint8)
    s, nbits = 3, 4
    plan = segment_ops.distribute_segments(s, payload.size)
    pp = segment_ops.raster_plane_plan(plan, img.size, nbits, 0, True)
    msg = jax_embed.pad_message(payload, img.size,
                                int(pp.offsets.max(initial=0)))
    cap = 1 << 21

    @jax.jit
    def flow(im, ms):
        stego = jax_embed.embed(im, ms, pp.starts, pp.lengths, pp.offsets,
                                jnp.int32(s), nbits)
        buf, n = jax_cc.compress_stage(stego, "deflate", cap)
        back = jax_cc.decompress_stage(buf, n, "deflate", im.shape, im.dtype)
        aligned = jax_embed.extract_aligned(back, pp.starts, pp.lengths,
                                            jnp.int32(s), nbits)
        return back, aligned

    want_back, want_aligned = flow(img, msg)
    want_bits = jax_embed.assemble_message(want_aligned, pp.offsets,
                                           pp.lengths, payload.size)

    stego = port_embed.embed(torch.from_numpy(img), torch.from_numpy(msg),
                             pp.starts, pp.lengths, pp.offsets, s, nbits)
    buf, n = port_cc.compress_stage(stego, "deflate", cap)
    back = port_cc.decompress_stage(buf, n, "deflate", img.shape, stego.dtype)
    aligned = port_embed.extract_aligned(back, pp.starts, pp.lengths, s,
                                         nbits)
    bits = port_embed.assemble_message(aligned.numpy(), pp.offsets,
                                       pp.lengths, payload.size)
    np.testing.assert_array_equal(back.numpy(), np.asarray(want_back))
    np.testing.assert_array_equal(aligned.numpy(), np.asarray(want_aligned))
    np.testing.assert_array_equal(bits, want_bits)
    np.testing.assert_array_equal(bits, payload)
