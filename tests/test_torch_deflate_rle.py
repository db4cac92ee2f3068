"""The plain version of the zlib-exact ``Z_RLE`` deflate encoder
(``codec_tcc_tpu_torch/ops/deflate_rle.py``), which is the spec of the
kernels in ``csrc/deflate_rle.cu``, against zlib itself; its window-slide
rule against a step-by-step replay of zlib's ``fill_window``; its probe; and
the transport codec's route on the CPU (the kernels' own tests, on a GPU,
are in ``test_torch_cuda.py``)."""

import zlib

import numpy as np
import pytest
import torch

import torch_deflate_cases as dc
from codec_tcc_tpu_torch import profiling
from codec_tcc_tpu_torch.io.codecs import get as get_codec
from codec_tcc_tpu_torch.ops import deflate_rle as d


def _zlib(data: bytes) -> bytes:
    co = zlib.compressobj(1, zlib.DEFLATED, 15, 9, zlib.Z_RLE)
    return co.compress(data) + co.flush()


@pytest.mark.parametrize("name", dc.NAMES)
def test_plain_encoder_gives_zlibs_bytes(name):
    image = dc.case(name)
    expect = get_codec("deflate").encode(image)
    assert d.encode_plain(image) == expect
    stream = d.split_stream(image)
    assert d.deflate_rle_plain(stream) == _zlib(stream.tobytes())
    # the tokens cover the stream once, in order
    pos, length = d.rle_tokens(stream)
    assert pos[0] == 0 and int(length.sum()) == stream.size
    assert np.array_equal(pos[1:], np.cumsum(length)[:-1])


def _fill_window_slides(n: int, starts) -> dict:
    """zlib's fill_window replayed step by step (window 2 * 32 KiB, all the
    input given at once): the slides done when each token start (and the
    end) is reached."""
    wsize = d.WSIZE
    state = {"strstart": 0, "lookahead": 0, "avail": n, "slides": 0}

    def fill():
        while True:
            more = 2 * wsize - state["lookahead"] - state["strstart"]
            if state["strstart"] >= wsize + wsize - d.MIN_LOOKAHEAD:
                state["strstart"] -= wsize
                more += wsize
                state["slides"] += 1
            if state["avail"] == 0:
                return
            take = min(state["avail"], more)
            state["avail"] -= take
            state["lookahead"] += take
            if not (state["lookahead"] < d.MIN_LOOKAHEAD and state["avail"]):
                return

    fill()
    out, prev = {}, 0
    for p in list(starts) + [n]:
        state["strstart"] += p - prev
        state["lookahead"] -= p - prev
        prev = p
        if state["lookahead"] <= d.MAX_MATCH:
            fill()
        out[p] = state["slides"]
    return out


@pytest.mark.parametrize("n", [1, 32768, 65273, 65276, 65536, 65537, 65800,
                               98304, 98305, 131072, 200003])
def test_slides_by_replays_fill_window(n):
    rng = np.random.default_rng(n)
    gaps = rng.choice([1, 1, 3, 258, 100, 257], size=n)
    starts = np.cumsum(np.r_[0, gaps])
    starts = starts[starts < n]
    for p, slides in _fill_window_slides(n, starts.tolist()).items():
        assert d.slides_by(p, n) == slides, (n, p)


def test_probe_covers_every_kind_of_block():
    kinds, forced, empty, lengths = set(), 0, 0, set()
    real = d.block_code

    def spy(lit_freq, dist_freq, stored_len, stored_ok):
        nonlocal forced, empty
        code = real(lit_freq, dist_freq, stored_len, stored_ok)
        kinds.add(code.kind)
        forced += (not stored_ok and real(lit_freq, dist_freq, stored_len,
                                          True).kind == d.STORED)
        empty += stored_len == 0
        return code

    d.block_code = spy
    try:
        for image in d.probe_images():
            assert d.encode_plain(image) == get_codec("deflate").encode(image)
            lengths.update(d.rle_tokens(d.split_stream(image))[1].tolist())
    finally:
        d.block_code = real
    assert kinds == {d.STORED, d.STATIC, d.DYNAMIC}
    assert forced and empty
    assert {256, 257, 258} <= lengths


def test_length_code_formula_matches_zlibs_table():
    """The kernels compute _length_code and base_length in closed form
    (csrc/deflate_rle.cu df_length_code); this is that form."""
    for lc in range(256):
        if lc == 255:
            code, xval = 28, 0
        elif lc < 8:
            code, xval = lc, 0
        else:
            e = lc.bit_length() - 3
            code, xval = 4 * e + 4 + ((lc >> e) & 3), lc & ((1 << e) - 1)
        assert code == d.LENGTH_CODE[lc]
        assert xval == lc - d.BASE_LENGTH[code] or code == 28


def test_transport_encode_stays_on_host_off_the_card():
    image = dc.case("odd_u16_37x53")
    codec = get_codec("deflate")
    before = profiling.counters()
    assert d.transport_encode(codec, image, None)() == codec.encode(image)
    assert d.transport_encode(codec, image, torch.from_numpy(image))() == \
        codec.encode(image)
    after = profiling.counters()
    assert after.get("codec.deflate_host", 0) - \
        before.get("codec.deflate_host", 0) == 2
    assert after.get("codec.deflate_device", 0) == \
        before.get("codec.deflate_device", 0)

    class Other:
        name = "png"

        def encode(self, arr):
            return b"other"

    assert d.transport_encode(Other(), image, torch.from_numpy(image))() == \
        b"other"
    assert profiling.counters().get("codec.deflate_host", 0) == \
        after.get("codec.deflate_host", 0)
