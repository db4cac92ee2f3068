"""The block-parallel inflate of the deflate codec's stego
(``codec_tcc_tpu_torch/ops/inflate.py``, ``csrc/inflate.cu``) on the CPU:
its plain version (``torch_inflate_plain.py``) against zlib (every block
of the phantoms' streams found, zlib's bytes rebuilt), its scan vectorised
against the same predicate offset by offset, the kernels' routines built
by a host compiler (``tests/torch_inflate_host.cpp``) against zlib and the
plain version, status for status and count for count, and the route:
foreign, corrupt and oversized streams go to the host codec, which raises
as before, and a status that says zlib refuses a stream zlib decodes
raises. The kernels' own tests, on a GPU, are in ``test_torch_cuda.py``."""

import ctypes
import re
import shutil
import subprocess
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_deflate_cases as dc
import torch_inflate_cases as ic
import torch_inflate_plain as plain
from codec_tcc_tpu_torch import profiling
from codec_tcc_tpu_torch.io.codecs import get as get_codec
from codec_tcc_tpu_torch.ops import inflate as inf

HERE = Path(__file__).resolve().parent
CSRC = HERE.parent / "codec_tcc_tpu_torch" / "csrc"

# the plain version's status on each payload the host must take (None: the
# kernels never see it)
HOST_STATUS = {
    "level6_default": inf.FOREIGN,
    "zlib_z_fixed": inf.FOREIGN,
    "no_distance_code": inf.FOREIGN,
    "one_distance_code": inf.FOREIGN,
    "one_end_code": inf.FOREIGN,
    "code2": None,
    "truncated": inf.BROKEN,
    "adler_flipped": inf.ADLER,
    "one_past": inf.LENGTH,
    "one_short": inf.LENGTH,
    "two_short_codes": inf.BROKEN,
}


def _want(blob) -> int:
    code, h, w = inf.sdfl_fields(blob)
    return h * w * (2 if code == 3 else 1)


def _limits(blob, lib=None):
    """The caps of the kernels (or of a host build ``lib``) for a payload."""
    nbytes = len(blob) - inf.SDFL_HEADER
    if lib is None:
        return inf.limits(nbytes, _want(blob))
    out = np.zeros(2, np.int64)
    lib.inflate_host_limits(nbytes, _want(blob), out.ctypes.data)
    return tuple(out.tolist())


def _plain(blob, lib=None):
    return plain.inflate_plain(blob, _limits(blob, lib)[0])


def _zlib_raw(blob) -> bytes:
    return zlib.decompress(bytes(blob[inf.SDFL_HEADER:]))


@pytest.mark.parametrize("name", ic.DEVICE)
def test_plain_inflate_gives_zlibs_bytes(name):
    blob = ic.payload(name)
    res = _plain(blob)
    assert res.status == inf.OK
    assert res.raw.tobytes() == _zlib_raw(blob)
    if name.startswith("fixed_code"):
        assert res.serial == res.blocks > 0
    if name.startswith("level0"):
        assert res.candidates == 0 and res.blocks > 1


def _block_kinds(stream: bytes, raw_len: int):
    """(stored, fixed, dynamic) blocks of a zlib stream, by decoding it with
    zlib itself one block at a time: the stream cut after each block that
    the plain version's walk found must inflate to that many bytes."""
    r = plain._Bits(stream)
    kinds = [0, 0, 0]
    p = 16
    while True:
        final, btype = r.get(p, 1), r.get(p + 1, 2)
        kinds[btype] += 1
        if btype == 0:
            q = (p + 3 + 7) & ~7
            p = 8 * (q // 8 + 4 + r.get(q, 16))
        else:
            t = (plain._fixed_tables(p) if btype == 1
                 else plain.dynamic_header(r, p))
            p = plain.decode_block(r, t, raw_len).end
        if final:
            return kinds


@pytest.mark.parametrize("h,w,seed", [(256, 256, 7), (256, 256, 8),
                                      (256, 256, 9), (512, 512, 7)])
def test_plain_inflate_finds_every_block_of_the_phantoms(h, w, seed):
    """On the benchmark's phantoms the scan finds every dynamic block and
    nothing else (no serial block, no candidate left over), and the blocks
    rebuild zlib's bytes."""
    blob = ic.phantom_payload(h, w, seed)
    res = _plain(blob)
    assert res.status == inf.OK and res.raw.tobytes() == _zlib_raw(blob)
    stored, fixed, dynamic = _block_kinds(bytes(blob[inf.SDFL_HEADER:]),
                                          _want(blob))
    assert res.blocks == stored + fixed + dynamic
    assert res.serial == fixed == 0
    assert res.candidates == dynamic > 0


@pytest.mark.parametrize("name", ["one_block_37x53", "corpus_phantom_64x64",
                                  "u8_200x300"])
def test_vectorised_scan_is_the_header_predicate(name):
    """scan_plain (every offset at once, as one thread per offset) finds the
    offsets where dynamic_header (one offset) holds, and no others."""
    stream = bytes(ic.payload(name)[inf.SDFL_HEADER:])
    stream = stream[:6000]
    r = plain._Bits(stream)
    one_by_one = [p for p in range(16, 8 * len(stream))
                  if plain.dynamic_header(r, p) is not None]
    assert plain.scan_plain(stream).tolist() == one_by_one
    assert one_by_one


@pytest.mark.parametrize("name", list(HOST_STATUS))
def test_plain_inflate_leaves_foreign_streams_to_the_host(name):
    blob = ic.payload(name)
    want = HOST_STATUS[name]
    if want is None:
        assert inf.sdfl_fields(blob) is None
        return
    assert _plain(blob).status == want


# ---------------------------------------------------------------------------
# the kernels' routines, built by a host compiler
# ---------------------------------------------------------------------------


# the kernels' sizes, and sizes small enough to reach every path at the
# corpus's lengths: windows of a few chunks, more windows than a candidate
# keeps records for (the emit then finds the chunks' starts itself),
# symbols longer than a chunk's starts (the walk decodes the chunk itself),
# and caps of two candidates and two emitted blocks (the chain decodes and
# emits the rest itself)
HOST_BUILDS = {"kernel": [],
               "tiny": ["-DINF_CTA=4", "-DINF_CHUNK=96", "-DINF_STARTS=12",
                        "-DINF_WINDOWS=3", "-DINF_CAP_MIN=2",
                        "-DINF_CAP_PER=65536", "-DINF_CHAIN_MIN=2",
                        "-DINF_CHAIN_PER=65536"]}


def _build_limits(build, nbytes, want):
    """The caps a host build sets (the kernels' own for ``kernel``)."""
    if build == "kernel":
        return inf.limits(nbytes, want)
    return 2 + nbytes // 65536, 2 + want // 65536


@pytest.fixture(scope="module", params=list(HOST_BUILDS))
def host_lib(request, tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernels' routines for the host")
    out = tmp_path_factory.mktemp("inflate_host") / "libinflate_host.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-shared", "-fPIC",
                    *HOST_BUILDS[request.param], "-I", str(CSRC), "-o",
                    str(out), str(HERE / "torch_inflate_host.cpp")],
                   check=True)
    lib = ctypes.CDLL(str(out))
    ptr, i64 = ctypes.c_void_p, ctypes.c_longlong
    lib.inflate_host.argtypes = [ptr, i64, ptr, i64, ctypes.c_int, ptr]
    lib.inflate_host.restype = ctypes.c_int
    lib.inflate_host_limits.argtypes = [i64, i64, ptr]
    lib.inflate_host_limits.restype = None
    lib.build = request.param
    return lib


def _run_host(lib, blob):
    """(status, the image, (candidates, blocks, serial)) of the
    routines on a payload, with the stream in words as the kernels read it."""
    code, h, w = inf.sdfl_fields(blob)
    item = 2 if code == 3 else 1
    stream = np.frombuffer(blob, np.uint8, offset=inf.SDFL_HEADER)
    words = np.zeros(4 * ((stream.size + 3) // 4 + 2), np.uint8)
    words[:stream.size] = stream
    out = np.zeros(h * w * item, np.uint8)
    counts = np.zeros(3, np.int64)
    status = lib.inflate_host(words.ctypes.data, stream.size, out.ctypes.data,
                              h * w, item, counts.ctypes.data)
    image = out.view(np.uint16 if item == 2 else np.uint8).reshape(h, w)
    return status, image, tuple(counts.tolist())


@pytest.mark.parametrize("name", [*ic.DEVICE, "phantom_512x512",
                                  *(n for n, s in HOST_STATUS.items() if s)])
def test_host_built_routines_match_zlib_and_the_plain_version(host_lib, name):
    blob = (ic.phantom_payload(512, 512, 7) if name == "phantom_512x512"
            else ic.payload(name))
    status, image, counts = _run_host(host_lib, blob)
    spec = _plain(blob, host_lib)
    assert status == spec.status
    assert counts == (spec.candidates, spec.blocks, spec.serial)
    if status == inf.OK:
        assert np.array_equal(image, get_codec("deflate").decode(blob))


@pytest.mark.parametrize("nbytes,want", [(2, 1), (5269296, 8388608),
                                         (331961, 524288), (1 << 28, 1)])
def test_limits_are_the_kernels(host_lib, nbytes, want):
    out = np.zeros(2, np.int64)
    host_lib.inflate_host_limits(nbytes, want, out.ctypes.data)
    assert tuple(out.tolist()) == _build_limits(host_lib.build, nbytes, want)


def test_status_words_are_the_kernels():
    src = (CSRC / "inflate.cu").read_text()
    names = ("OK", "BROKEN", "FOREIGN", "LENGTH", "ADLER")
    values = {n: int(re.search(rf"#define INF_{n} (\d+)", src).group(1))
              for n in names}
    assert values == {n: getattr(inf, n) for n in names}
    assert set(values.values()) == set(inf.STATUS) and inf.OK == 0
    assert int(re.search(r"#define INF_MAX_TOKENS (\d+)", src).group(1)) \
        == plain.MAX_TOKENS
    assert re.search(r"#define INF_MAX_STREAM \(\(1 << (\d+)\) - 1\)",
                     src).group(1) == "28" == str(inf.MAX_STREAM.bit_length())


@pytest.mark.parametrize("name", [*ic.DEVICE, *ic.HOST])
def test_plain_status_says_foreign_only_where_zlib_decodes(name):
    """The statuses that send a stream to zlib without a question (OK aside,
    FOREIGN) are those of streams zlib decodes to the header's length; every
    other status is a stream zlib refuses. So where zlib decodes a stream
    that the kernels gave another status, the kernels are at fault."""
    blob = ic.payload(name)
    if inf.sdfl_fields(blob) is None:
        return
    try:
        zlib_ok = len(_zlib_raw(blob)) == _want(blob)
    except zlib.error:
        zlib_ok = False
    assert (_plain(blob).status in (inf.OK, inf.FOREIGN)) == zlib_ok


# ---------------------------------------------------------------------------
# the route
# ---------------------------------------------------------------------------


def _counts_since(before):
    after = profiling.counters()
    return {k: after.get(k, 0) - before.get(k, 0)
            for k in ("codec.inflate_device", "codec.inflate_host",
                      *("launch." + k for k in inf.KERNELS))}


@pytest.mark.parametrize("name", [*HOST_STATUS, "corpus_odd_u16_37x53"])
def test_transport_decode_takes_the_host_route_on_the_cpu(name):
    """On the CPU every deflate payload is the host codec's: the same image
    or the same ``Invalid file:`` message, counted on the host side."""
    blob = ic.payload(name)
    codec = get_codec("deflate")
    try:
        want, err = codec.decode(blob), None
    except ValueError as exc:
        want, err = None, str(exc)
    assert not inf.device_route(codec, blob, torch.device("cpu"))
    before = profiling.counters()
    if err is None:
        got, got_dev = inf.transport_decode(codec, blob, torch.device("cpu"))
        assert got_dev is None and np.array_equal(got, want)
    else:
        with pytest.raises(ValueError) as info:
            inf.transport_decode(codec, blob, torch.device("cpu"))
        assert str(info.value) == err and err.startswith("Invalid file:")
    assert _counts_since(before) == {
        "codec.inflate_device": 0, "codec.inflate_host": 1,
        **{"launch." + k: 0 for k in inf.KERNELS}}


def test_device_route_takes_only_deflate_payloads_it_can_decode():
    codec = get_codec("deflate")
    cuda = torch.device("cuda")
    assert inf.device_route(codec, ic.payload("corpus_bytes1"), cuda)
    for name in ("code2",):
        assert not inf.device_route(codec, ic.payload(name), cuda)
    blob = ic.payload("corpus_odd_u16_37x53")
    assert not inf.device_route(codec, blob[:14], cuda)           # no zlib
    assert not inf.device_route(codec, blob[:13] + b"\x78\x02" + blob[15:],
                                cuda)                            # FCHECK
    assert not inf.device_route(codec, blob[:13] + b"\x78\x21" + blob[15:],
                                cuda)                            # FDICT
    huge = blob[:4] + bytes([3]) + (1 << 14).to_bytes(4, "big") * 2 + \
        blob[13:]                                                # 2**29 B
    assert not inf.device_route(codec, huge, cuda)

    class Other:
        name = "png"

    assert not inf.device_route(Other(), blob, cuda)
    before = profiling.counters()

    class Png:
        name = "png"

        def decode(self, data):
            return np.zeros((1, 1), np.uint8)

    got, got_dev = inf.transport_decode(Png(), blob, cuda)
    assert got_dev is None and got.shape == (1, 1)
    assert _counts_since(before)["codec.inflate_host"] == 0


def test_phantom_streams_have_the_shape_the_kernels_use():
    """The codec's stream of a phantom: blocks of every kind but fixed, every
    match at distance 1 (the plain version's status would be 3 otherwise),
    and a zlib header without a dictionary."""
    blob = get_codec("deflate").encode(dc.phantom(256, 256, seed=3))
    assert blob[inf.SDFL_HEADER:inf.SDFL_HEADER + 2] == b"\x78\x01"
    res = _plain(blob)
    assert res.status == inf.OK and res.serial == 0


@pytest.mark.parametrize("name,status,outcome", [
    ("corpus_odd_u16_37x53", inf.OK, "device"),
    ("level6_default", inf.FOREIGN, "host"),
    ("truncated", inf.BROKEN, "invalid"),
    ("adler_flipped", inf.ADLER, "invalid"),
    ("one_past", inf.LENGTH, "invalid"),
    ("corpus_odd_u16_37x53", inf.BROKEN, "disagree"),
    ("corpus_odd_u16_37x53", inf.LENGTH, "disagree"),
    ("corpus_odd_u16_37x53", inf.ADLER, "disagree"),
])
def test_transport_decode_routes_by_the_status(monkeypatch, name, status,
                                               outcome):
    """The card's status decides: OK is the card's image; FOREIGN is host
    zlib's; any other status is a stream zlib must refuse with its
    ``Invalid file:`` message, and where zlib decodes it instead the
    kernels are at fault and the decode raises."""
    blob = ic.payload(name)
    codec = get_codec("deflate")
    want = None
    try:
        want = codec.decode(blob)
    except ValueError as exc:
        err = str(exc)
    card = torch.from_numpy(want) if status == inf.OK else None
    monkeypatch.setattr(inf, "device_route", lambda *a: True)
    monkeypatch.setattr(inf, "inflate_device", lambda *a: inf.DeviceInflate(
        status, card, 1, 1, 0))
    before = profiling.counters()
    dev = torch.device("cpu")
    if outcome == "disagree":
        with pytest.raises(RuntimeError, match="refused a deflate stream"):
            inf.transport_decode(codec, blob, dev)
    elif outcome == "invalid":
        with pytest.raises(ValueError) as info:
            inf.transport_decode(codec, blob, dev)
        assert str(info.value) == err and err.startswith("Invalid file:")
    else:
        got, got_dev = inf.transport_decode(codec, blob, dev)
        assert np.array_equal(got, want)
        assert got_dev is (card if outcome == "device" else None)
    counts = _counts_since(before)
    assert counts["codec.inflate_device"] == int(outcome == "device")
    assert counts["codec.inflate_host"] == int(outcome != "device")
