"""The PEE decoders' overflow map kept packed: the port-only parse
(``models.pee.parse_pee_container_packed``) against the copied
``parse_pee_container_parts`` on the same containers, valid and malformed,
the map's expansion as torch ops (``ops.embed.expand_bits_tensor``, what a
CUDA device runs, here on CPU tensors) and on the host, and the counters
each CPU decode route leaves."""

import functools
import os
import zlib
from dataclasses import replace

import numpy as np
import pytest
import torch

import codec_tcc_tpu_torch as port
from codec_tcc_tpu_torch import profiling
from codec_tcc_tpu_torch.io import container as container_io
from codec_tcc_tpu_torch.models import pee as port_pee
from codec_tcc_tpu_torch.ops import embed as embed_ops

import torch_port_cases as cases

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "data", "golden_pee.stgc")


@functools.lru_cache(maxsize=None)
def _port_container(h, w, nbits):
    img = cases.image(cases.Case("t", h, w, "uint16", 12, "text", "pee", 41))
    bits = np.random.default_rng(h * w + nbits).integers(0, 2, nbits,
                                                         dtype=np.uint8)
    return port.encode_array(img, bits, port.EncodeConfig(strategy="pee"),
                             bits_stored=12, device="cpu").container


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _with_map(cont, raw: bytes):
    """``cont`` with its overflow map blob replaced by ``raw`` deflated."""
    return container_io.Container(cont.meta, zlib.compress(raw),
                                  cont.stego_blob)


def _dense(h, w, pad):
    """A 2048x2048 (or any) container whose map is half set, from random
    bytes, with ``pad`` lane-padding bytes of set bits past ``ceil(h*w/8)``:
    the tail the expansion must drop."""
    cont = container_io.parse(_port_container(h, w, 304))
    n = h * w
    raw = np.random.default_rng(n).integers(0, 256, (n + 7) // 8 + pad,
                                            dtype=np.uint8)
    raw[(n + 7) // 8:] = 0xFF
    return _with_map(cont, raw.tobytes())


VALID = {
    "port_512": lambda: container_io.parse(_port_container(512, 512, 100_000)),
    "port_511x513": lambda: container_io.parse(
        _port_container(511, 513, 50_000)),
    "port_2048_text": lambda: container_io.parse(
        _port_container(2048, 2048, 304)),
    "port_2048_1m": lambda: container_io.parse(
        _port_container(2048, 2048, 1_000_000)),
    "golden_pee": lambda: container_io.parse(_read(GOLDEN)),
    "dense_2048_padded": lambda: _dense(2048, 2048, 16),
    "dense_511x513_padded": lambda: _dense(511, 513, 3),
}


@pytest.mark.parametrize("name", list(VALID))
def test_packed_parse_and_expansion_match_the_copy(name):
    """The same ``ext``; the packed bytes expanded by torch ops on a CPU
    tensor, and by :func:`overflow_map_on` on the CPU device, give the
    copy's ``(h, w)`` map bit for bit, whatever ``h*w`` is mod 8."""
    cont = VALID[name]()
    h, w = cont.meta.height, cont.meta.width
    ext, want = port_pee.parse_pee_container_parts(cont)
    ext_p, raw = port_pee.parse_pee_container_packed(cont)
    assert ext_p == ext
    assert 8 * len(raw) >= h * w
    packed = np.frombuffer(raw, np.uint8)[:(h * w + 7) // 8].copy()
    got = embed_ops.expand_bits_tensor(torch.from_numpy(packed))
    assert got.dtype == torch.uint8 and got.numel() == 8 * packed.size
    np.testing.assert_array_equal(
        got[:h * w].view(h, w).numpy(), want.astype(np.uint8))
    before = profiling.counters()
    on = port_pee.overflow_map_on(raw, h, w, "cpu")
    after = profiling.counters()
    assert on.dtype == torch.uint8 and tuple(on.shape) == (h, w)
    np.testing.assert_array_equal(on.numpy(), want.astype(np.uint8))
    assert after.get("pee.map_host", 0) - before.get("pee.map_host", 0) == 1
    assert after.get("pee.map_device", 0) == before.get("pee.map_device", 0)


def _ext(cont, **fields):
    t, passes, n0, n1, b0, b1 = container_io.parse_pee_ext(cont.meta.ext)
    vals = dict(t=t, passes=passes, n0=n0, n1=n1, b0=b0, b1=b1)
    vals.update(fields)
    meta = replace(cont.meta, ext=container_io.pack_pee_ext(
        vals["t"], vals["passes"], vals["n0"], vals["n1"], vals["b0"],
        vals["b1"]))
    return container_io.Container(meta, cont.bitmaps_blob, cont.stego_blob)


def _meta(cont, **fields):
    return container_io.Container(replace(cont.meta, **fields),
                                  cont.bitmaps_blob, cont.stego_blob)


def _map_bytes(cont, nbytes):
    return _with_map(cont, bytes(nbytes))


def _n(cont):
    return cont.meta.height * cont.meta.width


MALFORMED = {
    "truncated_ext": lambda c: _meta(c, ext=c.meta.ext[:-1]),
    "t_0": lambda c: _ext(c, t=0),
    "t_129": lambda c: _ext(c, t=129),
    "passes_3": lambda c: _ext(c, passes=3),
    "nproc0_past_n": lambda c: _ext(c, n0=_n(c) + 1),
    "nproc1_past_n": lambda c: _ext(c, n1=_n(c) + 1),
    "bits1_past_n": lambda c: _ext(c, b1=_n(c) + 1),
    "payload_over_totals": lambda c: _meta(
        c, payload_bits=sum(container_io.parse_pee_ext(c.meta.ext)[4:]) + 1),
    "huge_dims": lambda c: _meta(c, width=1 << 20, height=1 << 20),
    "corrupt_map_blob": lambda c: container_io.Container(
        c.meta, b"\x78\x9c garbage", c.stego_blob),
    "map_one_byte_short": lambda c: _map_bytes(c, (_n(c) + 7) // 8 - 1),
    "map_past_its_bound": lambda c: _map_bytes(c, (_n(c) + 7) // 8 + 8192),
}


@pytest.mark.parametrize("geometry", [(512, 512, 100_000),
                                      (511, 513, 50_000)],
                         ids=["512", "511x513"])
@pytest.mark.parametrize("name", list(MALFORMED))
def test_packed_parse_refuses_as_the_copy(name, geometry):
    """Each malformed container raises the same ``Invalid file:``
    ``ValueError``, message for message, from both parses and from the CPU
    decode that runs the packed one."""
    cont = MALFORMED[name](container_io.parse(_port_container(*geometry)))
    with pytest.raises(ValueError) as copy_err:
        port_pee.parse_pee_container_parts(cont)
    with pytest.raises(ValueError) as packed_err:
        port_pee.parse_pee_container_packed(cont)
    assert str(copy_err.value).startswith("Invalid file:")
    assert str(packed_err.value) == str(copy_err.value)
    with pytest.raises(ValueError) as dec_err:
        port_pee.decode_pee_container(cont, device=torch.device("cpu"))
    assert str(dec_err.value) == str(copy_err.value)


def _decode_single(blob):
    return [port.decode_container(blob, device="cpu")]


def _decode_tiled(blob):
    from codec_tcc_tpu_torch.parallel import make_mesh, tile_pee

    mesh = make_mesh(devices=["cpu"] * 4, axes=("tile",))
    return [tile_pee.decode_container_tiled_pee(blob, mesh)]


def _decode_batch(blob):
    from codec_tcc_tpu_torch.parallel import batch_pee

    return batch_pee.decode_pee_batch([blob, blob], device="cpu")


@pytest.mark.parametrize("route,maps", [(_decode_single, 1),
                                        (_decode_tiled, 1),
                                        (_decode_batch, 2)],
                         ids=["single", "tiled", "batch"])
def test_cpu_decodes_expand_the_map_on_the_host(route, maps):
    """On the CPU every PEE decode route expands its map on the host, one
    ``pee.map_host`` a container, and decodes exactly."""
    blob = _port_container(511, 513, 50_000)
    img = cases.image(cases.Case("t", 511, 513, "uint16", 12, "text", "pee",
                                 41))
    before = profiling.counters()
    decs = route(blob)
    after = profiling.counters()
    assert {k: after.get(k, 0) - before.get(k, 0)
            for k in ("pee.map_host", "pee.map_device")} == {
        "pee.map_host": maps, "pee.map_device": 0}
    bits = np.random.default_rng(511 * 513 + 50_000).integers(
        0, 2, 50_000, dtype=np.uint8)
    for dec in decs:
        np.testing.assert_array_equal(dec.payload_bits, bits)
        np.testing.assert_array_equal(dec.original, img)
