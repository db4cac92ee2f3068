"""The port's tile-sharded PEE (``parallel/tile_pee.py``, K3/K4 in band
mode through their plain band versions on the CPU) against the JAX
package's on a mesh of CPU devices.

* The band plain versions (``ops/pee.py``: ``embed_pass_band``,
  ``extract_pass_band``, ``band_eligible_count``,
  ``band_capacity_histogram``, and the band kernels' ``band_tile_counts``,
  ``embed_pass_band_tiles`` and ``band_extract_tile_counts``, through the
  wrappers' CPU route) against the JAX per-shard XLA route
  (``tile_pee._shard_classify``, ``_global_geometry``, ``_predict_block``,
  ``embed_pass_tiled``, ``extract_pass_tiled``) and against the Pallas
  kernels' shard mode in interpret mode (``embed_pass_batch`` /
  ``extract_pass_batch(shard=...)``) at 1024x128 over two bands, the
  smallest geometry that route takes; the bands stitched together equal
  the whole-image passes.
* Containers of ``encode_array_tiled_pee`` equal to the JAX package's
  ``encode_array_tiled_pee(..., backend="xla")`` on its 8-device CPU mesh
  and to the port's single-device container, for K in 1, 2, 4, 8, with
  one and two passes, u8 and ``bits_stored``, the 509x512 odd geometry,
  more bands than rows, the CapacityError, and the quality metrics at the
  tolerance the single-image tests use.

Everything is exact but the float32 metrics (rel 1e-5 on mse, as
``tests/test_tile.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import codec_tcc_tpu as jax_pkg
from codec_tcc_tpu.models import pee as jax_model
from codec_tcc_tpu.ops import pallas_pee as pp
from codec_tcc_tpu.ops import pee as jax_pee
from codec_tcc_tpu.parallel import mesh as jax_mesh
from codec_tcc_tpu.parallel import tile_pee as jax_tile_pee
import codec_tcc_tpu_torch as port
from codec_tcc_tpu_torch.errors import CapacityError
from codec_tcc_tpu_torch.io.container import parse_pee_ext
from codec_tcc_tpu_torch.ops import pee as port_pee
from codec_tcc_tpu_torch.ops import pee_kernels as pk
from codec_tcc_tpu_torch.parallel import mesh as port_mesh
from codec_tcc_tpu_torch.parallel import tile_pee as port_tile_pee

import torch_tile_cases as tiles

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jax_tile_mesh():
    return jax_mesh.make_mesh(8, ("tile",))


def _cpu_mesh(k):
    return port_mesh.make_mesh(devices=["cpu"] * k, axes=("tile",))


def _smooth(h, w, seed, peak=900, dtype=np.uint16):
    """A smooth image with +-1 noise: PEE embeds a few bits per 10 px."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = peak // 2 + (peak // 3) * np.sin(yy / 23.0) * np.cos(xx / 31.0)
    return (base.astype(np.int64) + rng.integers(-1, 2, size=(h, w))).clip(
        0, peak).astype(dtype)


def _halo(img, a, b):
    """``torch_tile_cases.halo`` of a numpy image: (top, bottom) rows."""
    return tuple(r[0].numpy() for r in tiles.halo(_t(img[None]), a, b))


def _t(x, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(x))
    return t if dtype is None else t.to(dtype)


def _i32(v):
    return torch.tensor([int(v)], dtype=torch.int32)


# ---------------------------------------------------------------------------
# the band plain versions against the JAX per-shard XLA formulas
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("h,w,k", [(64, 48, 3), (37, 53, 4), (50, 33, 7)])
@pytest.mark.parametrize("parity", [0, 1])
def test_band_formulas_match_the_jax_shard_route(h, w, k, parity):
    """Geometry, prediction, classification counts and the capacity
    histogram of every band equal the JAX per-shard functions', and the
    band histograms sum to the whole image's."""
    img = _smooth(h, w, seed=h + k, peak=255, dtype=np.uint8)
    hist = 0
    for a, b in tiles.bands(h, k):
        top, bot = _halo(img, a, b)
        blk = img[a:b]
        in_set, rank = port_pee._band_geometry(b - a, w, _i32(a), h, parity)
        j_in, j_rank = jax_tile_pee._global_geometry(b - a, h, w, a, parity)
        np.testing.assert_array_equal(in_set[0].numpy(), np.asarray(j_in))
        np.testing.assert_array_equal(
            np.where(in_set[0].numpy(), rank[0].numpy(), 0),
            np.where(np.asarray(j_in), np.asarray(j_rank), 0))
        np.testing.assert_array_equal(
            port_pee._predict_band(_t(blk[None]), _t(top[None]),
                                   _t(bot[None]))[0].numpy(),
            np.asarray(jax_tile_pee._predict_block(
                jnp.asarray(blk), jnp.asarray(top[None]),
                jnp.asarray(bot[None]))))
        for t in (1, 2, 9):
            cnt = port_pee.band_eligible_count(
                _t(blk[None]), _t(top[None]), _t(bot[None]), _i32(a),
                parity, t, 255, h)
            assert int(cnt[0]) == int(jax_tile_pee._shard_classify_count(
                jnp.asarray(blk), jnp.asarray(top[None]),
                jnp.asarray(bot[None]), a, h, w, parity, t, 255))
        hist = hist + port_pee.band_capacity_histogram(
            _t(blk[None]), _t(top[None]), _t(bot[None]), _i32(a), parity,
            128, 255, h)[0].numpy()
    np.testing.assert_array_equal(
        hist, np.asarray(jax_pee.capacity_histogram(img, parity, 128, 255)))


# (name, h, w, bands, dtype, max_val): two 65,536-pixel bands (the
# smallest geometry of the TPU route), the odd 509x512 over four, more
# bands than rows, and u8 at BitsStored 8 and 12 (pixels wrap past 255)
TILE_COUNT_CASES = [
    ("1024x128_k2", 1024, 128, 2, np.uint16, 4095),
    ("509x512_k4", 509, 512, 4, np.uint16, 4095),
    ("5x64_k8", 5, 64, 8, np.uint16, 4095),
    ("u8_bs8_k3", 40, 48, 3, np.uint8, 255),
    ("u8_bs12_k3", 67, 45, 3, np.uint8, 4095),
]


@pytest.mark.parametrize("case", TILE_COUNT_CASES, ids=lambda c: c[0])
@pytest.mark.parametrize("parity", [0, 1])
def test_band_tile_counts_match_the_jax_shard_count(case, parity):
    """K3's band count launch through its wrapper (``band_tile_counts`` on
    the CPU): each tile's count equals the JAX shard classification's
    eligible pixels in that tile's 4096 band pixels, a band's row sums to
    ``_shard_classify_count`` and to ``band_eligible_count``, and the rows
    of all bands sum to the image's capacity (``ops.pee.capacity``)."""
    _, h, w, k, dtype, max_val = case
    img = _smooth(h, w, seed=h * w + parity, peak=min(max_val, 900),
                  dtype=dtype)
    t = 3
    total = 0
    for a, b in tiles.bands(h, k):
        top, bot = _halo(img, a, b)
        blk = img[a:b]
        counts = pk.pee_count_band(_t(blk[None]), _t(top[None]),
                                   _t(bot[None]), a, h, parity, t, max_val)
        j_elig = np.asarray(jax_tile_pee._shard_classify(
            jnp.asarray(blk), jnp.asarray(top[None]), jnp.asarray(bot[None]),
            a, h, w, parity, t, max_val)[-1]).reshape(-1)
        n_tiles = -(-j_elig.size // port_pee.TILE_PX)
        j_tiles = np.pad(j_elig, (0, n_tiles * port_pee.TILE_PX - j_elig.size))
        np.testing.assert_array_equal(
            counts[0].numpy(),
            j_tiles.reshape(n_tiles, -1).sum(1, dtype=np.int32))
        count = int(counts.sum())
        assert count == int(jax_tile_pee._shard_classify_count(
            jnp.asarray(blk), jnp.asarray(top[None]), jnp.asarray(bot[None]),
            a, h, w, parity, t, max_val))
        assert count == int(port_pee.band_eligible_count(
            _t(blk[None]), _t(top[None]), _t(bot[None]), _i32(a), parity, t,
            max_val, h)[0])
        total += count
    assert total == int(jax_pee.capacity(img, parity, t, max_val))


def _port_pass_by_bands(img, k, msg, base, want, parity, t, max_val):
    """One pass through K3's band wrappers band by band (their plain
    versions on the CPU), ``torch_tile_cases.embed``: each band's tile
    counts sum to its plain eligible count, and its apply from the tiles'
    offsets equals ``embed_pass_band``. Returns (stego, overflow, used,
    nproc) of the whole image as numpy and ints."""
    per_band, (stego, over, used, nproc) = tiles.embed(
        _t(img[None]), _t(msg[None]), base, want, parity, t, max_val, k)
    h = img.shape[0]
    rank_base = 0
    for (a, b), (counts, s_k, o_k, n_k) in zip(tiles.bands(h, k), per_band):
        top, bot = tiles.halo(_t(img[None]), a, b)
        band = _t(img[None, a:b])
        count = port_pee.band_eligible_count(band, top, bot, _i32(a), parity,
                                             t, max_val, h)
        assert int(counts.sum()) == int(count[0])
        ref = port_pee.embed_pass_band(band, top, bot, _i32(a),
                                       _i32(rank_base), _t(msg[None]),
                                       _i32(base), _i32(want), parity, t,
                                       max_val, h)
        for got, want_k in zip((s_k, o_k, count, n_k), ref):
            assert torch.equal(got, want_k)
        rank_base += int(count[0])
    return stego[0].numpy(), over[0].numpy(), used, nproc


def _port_extract_by_bands(stego, over, nproc, k, parity, t, out_len):
    """The inverse through K4's band wrapper band by band: each band's bit
    row is band-sized (its in-set pixels, at most ``out_len``)."""
    per_band, (restored, bits, n_bits) = tiles.extract(
        _t(stego[None]), _t(over[None]), nproc, parity, t, out_len, k)
    h, w = stego.shape
    for (a, b), (counts, _, _, n_k) in zip(tiles.bands(h, k), per_band):
        assert int(counts.sum()) == int(n_k[0])
        top, bot = tiles.halo(_t(stego[None]), a, b)
        row = pk.pee_extract_band(_t(stego[None, a:b]), top, bot, a, h,
                                  _t(over[None, a:b]), nproc, parity, t,
                                  out_len)[1]
        assert row.shape == (1, min(out_len, port_pee.band_set_count(
            a, b - a, h, w, parity)))
    return restored[0].numpy(), bits.numpy(), n_bits


@pytest.mark.parametrize("k", [2, 3, 8])
@pytest.mark.parametrize("parity", [0, 1])
@pytest.mark.parametrize("want", [0, 1, 150, 5000], ids=lambda v: f"want{v}")
def test_band_passes_match_jax_and_the_whole_image(jax_tile_mesh, k, parity,
                                                   want):
    """The bands' K3/K4 plain versions, stitched, equal the JAX XLA shard
    route's pass and the port's whole-image pass, under capacity, at it
    and saturated (5000 > cap), and the inverse restores the image."""
    h, w, t, max_val = 61, 40, 3, 4095
    img = _smooth(h, w, seed=k, peak=4095)
    msg = np.random.default_rng(want).integers(0, 2, 8192, dtype=np.uint8)
    base = 7
    stego, over, used, nproc = _port_pass_by_bands(img, k, msg, base, want,
                                                   parity, t, max_val)

    j_mesh = jax_mesh.make_mesh(k, ("tile",))
    j_st, j_ov, j_used, j_np = jax_tile_pee.embed_pass_tiled(
        img, msg, base, want, parity, t, max_val, j_mesh, "tile", h=h)
    np.testing.assert_array_equal(stego, np.asarray(j_st)[:h])
    np.testing.assert_array_equal(over, np.asarray(j_ov)[:h].astype(np.uint8))
    assert (used, nproc) == (int(j_used), int(j_np))

    whole = port_pee.embed_pass(
        _t(img[None]), _t(msg[None]), _i32(base), _i32(want), parity, t,
        max_val)
    np.testing.assert_array_equal(stego, whole[0][0].numpy())
    np.testing.assert_array_equal(over, whole[1][0].numpy())
    assert (used, nproc) == (int(whole[2][0]), int(whole[3][0]))

    out_len = 256
    restored, bits, n_bits = _port_extract_by_bands(stego, over, nproc, k,
                                                    parity, t, out_len)
    j_r, j_bits, j_n = jax_tile_pee.extract_pass_tiled(
        stego, over.astype(bool), nproc, parity, t, max_val, out_len,
        j_mesh, "tile", h=h)
    np.testing.assert_array_equal(restored, np.asarray(j_r)[:h])
    np.testing.assert_array_equal(bits, j_bits)
    assert n_bits == j_n == used
    np.testing.assert_array_equal(restored, img)
    w_r, w_bits, w_n = port_pee.extract_pass(
        _t(stego[None]), _t(over[None]), _i32(nproc), parity, t, out_len)
    np.testing.assert_array_equal(bits, w_bits[0].numpy())
    assert n_bits == int(w_n[0])


@pytest.mark.parametrize("parity", [0, 1])
def test_band_passes_match_the_pallas_shard_mode(parity):
    """At 1024x128 over two bands (one 65,536-pixel kernel tile each, the
    smallest geometry of the TPU route), the Pallas kernels' shard mode in
    interpret mode gives the same bands as the plain band versions: stego
    and overflow of the embed, the pass's used count and boundary, and the
    inverse's restored bands and bits."""
    h, w, k, t, max_val = 1024, 128, 2, 4, 4095
    img = _smooth(h, w, seed=5 + parity, peak=4095)
    msg = np.random.default_rng(9).integers(0, 2, 40_000, dtype=np.uint8)
    want = 30_000
    msg_pad = np.zeros(1 << 16, np.uint8)
    msg_pad[:msg.size] = msg
    stego, over, used, nproc = _port_pass_by_bands(img, k, msg_pad, 0, want,
                                                   parity, t, max_val)

    msg2d, l2 = pp.prep_messages(msg_pad[None], h * w)
    lh = h // k
    z = jnp.zeros(1, jnp.int32)
    rank_base, j_st, j_ov, j_np, total = 0, [], [], [], 0
    for i in range(k):
        blk = jnp.asarray(img[i * lh:(i + 1) * lh])
        top, bot = (jnp.asarray(r[None]) for r in _halo(img, i * lh,
                                                         (i + 1) * lh))
        cnt = int(jax_tile_pee._shard_classify_count(
            blk, top, bot, i * lh, h, w, parity, t, max_val))
        s3, o3, _, n_sh = pp.embed_pass_batch(
            None, msg2d, z, jnp.full(1, want, jnp.int32), h, w, parity, t,
            max_val, l2, interpret=True,
            shard=(jax_tile_pee._shard_pad_buffer(blk, top, bot, w),
                   jnp.full(1, i * lh * w, jnp.int32),
                   jnp.full(1, rank_base, jnp.int32)))
        j_st.append(np.asarray(s3[0]).reshape(lh, w))
        j_ov.append(np.asarray(o3[0]).reshape(lh, w))
        j_np.append(int(n_sh[0]))
        rank_base += cnt
    j_used = min(want, rank_base)
    j_nproc = h * w if want > rank_base else (max(j_np) if j_used else 0)
    np.testing.assert_array_equal(stego, np.concatenate(j_st))
    np.testing.assert_array_equal(over, np.concatenate(j_ov))
    assert (used, nproc) == (j_used, j_nproc)
    assert 0 < used == want        # a partial pass: the boundary is inside

    out_len = 1 << 15
    restored, bits, n_bits = _port_extract_by_bands(stego, over, nproc, k,
                                                    parity, t, out_len)
    over3 = over.reshape(k, lh * w // 128, 128)
    j_r, segs, cnts = [], [], []
    for i in range(k):
        blk = jnp.asarray(stego[i * lh:(i + 1) * lh])
        top, bot = (jnp.asarray(r[None]) for r in _halo(stego, i * lh,
                                                         (i + 1) * lh))
        r3, sg, ct = pp.extract_pass_batch(
            None, jnp.asarray(over3[i:i + 1]), jnp.full(1, nproc, jnp.int32),
            h, w, parity, t, max_val, interpret=True,
            shard=(jax_tile_pee._shard_pad_buffer(blk, top, bot, w),
                   jnp.full(1, i * lh * w, jnp.int32)))
        j_r.append(np.asarray(r3[0]).reshape(lh, w))
        segs.append(np.asarray(sg[0]))
        cnts.append(np.asarray(ct[0]))
    j_bits = jax_tile_pee._collect_shard_bits(np.stack(segs), np.stack(cnts),
                                              out_len)
    np.testing.assert_array_equal(restored, np.concatenate(j_r))
    np.testing.assert_array_equal(bits, j_bits)
    assert n_bits == int(np.sum(cnts)) == used
    np.testing.assert_array_equal(restored, img)


# ---------------------------------------------------------------------------
# the tiled encode/decode path
# ---------------------------------------------------------------------------


def assert_same_report(got, want, image, stego):
    """Quality reports from per-band and whole-image float32 moments: the
    fields of integer moments exactly, ``mse`` at rel 1e-5 where it is the
    accumulated squared difference. Where the embed moved the maximum,
    ``quality_report`` rescales both images and takes ``mse`` from moments
    near 1e9 that cancel (ROADMAP queue 3, the normalised branch), so sums
    in another order differ past float32 rounding there; then only the
    fields that do not cancel are compared."""
    for key in ("mean_abs_diff", "max_abs_diff", "changed_pixels",
                "changed_percent", "max_value"):
        assert got[key] == want[key], key
    if int(image.max()) == int(stego.max()):
        assert got["mse"] == pytest.approx(want["mse"], rel=1e-5)


def _jax_cfg(**kw):
    return jax_pkg.EncodeConfig(strategy="pee", **kw)


def _port_cfg(**kw):
    return port.EncodeConfig(strategy="pee", **kw)


@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_tiled_pee_containers_match_jax_and_single_device(jax_tile_mesh, k):
    """One pass and two (payload past pass 0), on K CPU devices: the
    containers equal the JAX package's tiled (XLA route, 8-device mesh)
    and the port's single-device container, and decode exactly; the
    quality report equals the single-device one (rel 1e-5 on mse)."""
    img = _smooth(128, 128, seed=13, peak=600)
    mesh = _cpu_mesh(k)
    for nbits in (2_000, 9_500):
        bits = np.random.default_rng(nbits).integers(0, 2, nbits,
                                                     dtype=np.uint8)
        res = port_tile_pee.encode_array_tiled_pee(img, bits, _port_cfg(),
                                                   mesh)
        single = port.encode_array(img, bits, _port_cfg(), device="cpu")
        j_res = jax_tile_pee.encode_array_tiled_pee(
            img, bits, _jax_cfg(), jax_tile_mesh, backend="xla")
        assert res.container == single.container == j_res.container
        passes = parse_pee_ext(res.meta.ext)[1]
        assert passes == (1 if nbits == 2_000 else 2)
        assert_same_report(res.metrics, single.metrics, img, res.stego)
        dec = port_tile_pee.decode_container_tiled_pee(res.container, mesh)
        np.testing.assert_array_equal(dec.payload_bits, bits)
        np.testing.assert_array_equal(dec.original, img)


@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_tiled_pee_odd_geometry_matches_jax(jax_tile_mesh, k):
    """509x512 (prime rows): the port's shorter last band gives the bytes
    of the JAX package's zero-padded one and of the single-device
    encoder."""
    img = np.clip(
        400 + 40 * np.sin(np.arange(509)[:, None] / 23.0)
        + 40 * np.cos(np.arange(512)[None, :] / 31.0)
        + np.random.default_rng(17).integers(-2, 3, size=(509, 512)),
        0, 4095).astype(np.uint16)
    payload = np.random.default_rng(17).bytes(900)
    cfg = dict(compute_metrics=False)
    mesh = _cpu_mesh(k)
    res = port_tile_pee.encode_array_tiled_pee(img, payload, _port_cfg(**cfg),
                                               mesh)
    single = port.encode_array(img, payload, _port_cfg(**cfg), device="cpu")
    assert res.container == single.container
    if k == 8:
        j_res = jax_tile_pee.encode_array_tiled_pee(
            img, payload, _jax_cfg(**cfg), jax_tile_mesh, backend="xla")
        assert res.container == j_res.container
    dec = port_tile_pee.decode_container_tiled_pee(res.container, mesh)
    assert dec.payload == payload
    np.testing.assert_array_equal(dec.original, img)


def test_tiled_pee_u8_bits_stored_and_more_bands_than_rows(jax_tile_mesh):
    """u8 with BitsStored 8 over 8 bands, and a 5-row u16 image with
    BitsStored 12 over 8 bands (three empty): the JAX package's bytes."""
    img8 = _smooth(40, 48, seed=3, peak=255, dtype=np.uint8)
    bits = np.random.default_rng(3).integers(0, 2, 300, dtype=np.uint8)
    res = port_tile_pee.encode_array_tiled_pee(img8, bits, _port_cfg(),
                                               _cpu_mesh(8), bits_stored=8)
    j_res = jax_tile_pee.encode_array_tiled_pee(
        img8, bits, _jax_cfg(), jax_tile_mesh, bits_stored=8, backend="xla")
    assert res.container == j_res.container

    img5 = _smooth(5, 64, seed=4, peak=4095)
    bits5 = np.random.default_rng(4).integers(0, 2, 40, dtype=np.uint8)
    res5 = port_tile_pee.encode_array_tiled_pee(img5, bits5, _port_cfg(),
                                                _cpu_mesh(8), bits_stored=12)
    single = port.encode_array(img5, bits5, _port_cfg(), bits_stored=12,
                               device="cpu")
    assert res5.container == single.container
    dec = port_tile_pee.decode_container_tiled_pee(res5.container,
                                                   _cpu_mesh(8))
    np.testing.assert_array_equal(dec.payload_bits, bits5)
    np.testing.assert_array_equal(dec.original, img5)


def test_tiled_pee_capacity_error_and_bad_calls():
    img = _smooth(32, 32, seed=1, peak=600)
    with pytest.raises(CapacityError, match="exceeds PEE capacity even at "
                                            "T=128"):
        port_tile_pee.encode_array_tiled_pee(img, np.ones(5_000, np.uint8),
                                             _port_cfg(), _cpu_mesh(2))
    with pytest.raises(ValueError, match="requires a mesh"):
        port_tile_pee.encode_array_tiled_pee(img, b"x", _port_cfg())
    raster = port.encode_array(img, b"x", device="cpu").container
    with pytest.raises(ValueError, match="not a PEE container"):
        port_tile_pee.decode_container_tiled_pee(raster, _cpu_mesh(2))


def test_tiled_pee_kernel_calls_are_one_per_band_per_pass(monkeypatch):
    """Each pass calls K3's band count and apply wrappers once per band,
    each inverse pass K4's band wrapper once per band: the launch counts
    that ``chip_smoke.py`` requires on the card (K per pass per attempt);
    the rank prefix comes from the count wrapper, never from
    ``band_eligible_count``."""
    calls = {"count": 0, "embed": 0, "extract": 0}

    def counted(name, fn):
        def wrapper(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapper

    def refused(*args, **kwargs):
        raise AssertionError("band_eligible_count on the band path")
    monkeypatch.setattr(pk, "pee_count_band",
                        counted("count", pk.pee_count_band))
    monkeypatch.setattr(pk, "pee_embed_band",
                        counted("embed", pk.pee_embed_band))
    monkeypatch.setattr(pk, "pee_extract_band",
                        counted("extract", pk.pee_extract_band))
    monkeypatch.setattr(port_pee, "band_eligible_count", refused)
    img = _smooth(64, 64, seed=8, peak=600)
    bits = np.random.default_rng(3_800).integers(0, 2, 3_800, dtype=np.uint8)
    res = port_tile_pee.encode_array_tiled_pee(
        img, bits, _port_cfg(compute_metrics=False), _cpu_mesh(4))
    t, passes = parse_pee_ext(res.meta.ext)[:2]
    caps = [jax_pee.capacities_by_threshold(
        jax_pee.capacity_histogram(img, p, 128, 65535)) for p in (0, 1)]
    t0 = jax_model.select_threshold(caps[0], caps[1], bits.size, 2)
    assert passes == 2 and t > t0      # escalated after a pass-1 shortfall
    assert calls["count"] == calls["embed"] == 4 * (2 * (t - t0) + passes)
    dec = port_tile_pee.decode_container_tiled_pee(res.container,
                                                   _cpu_mesh(4))
    assert calls["extract"] == 4 * passes
    np.testing.assert_array_equal(dec.payload_bits, bits)
