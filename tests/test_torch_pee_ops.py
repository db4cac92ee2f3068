"""Plain PEE ops of the port and the plain versions of its kernels K3
``pee_embed`` and K4 ``pee_extract`` against the JAX package: the XLA
``codec_tcc_tpu.ops.pee`` and the Pallas ``embed_pass_batch`` /
``extract_pass_batch`` + ``collect_bits`` (interpret mode on the CPU, as
``tests/test_pallas_pee.py`` runs them). Inputs are numpy-seeded; every
comparison is exact.

The CUDA kernels themselves are held against these plain versions on the
GPU (``chip_smoke.py``, ``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from codec_tcc_tpu.ops import pallas_pee as pp
from codec_tcc_tpu.ops import pee as jax_pee
from codec_tcc_tpu_torch import profiling
from codec_tcc_tpu_torch.ops import pee as torch_pee
from codec_tcc_tpu_torch.ops import pee_kernels as pk

import torch_pee_stress as stress
from torch_parity import same_code

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _interpret_mode():
    from jax.experimental.pallas import tpu as pltpu

    if jax.default_backend() == "tpu":
        yield
        return
    with pltpu.force_tpu_interpret_mode():
        yield


def _carriers(rng, b, h, w, dtype, hi):
    """Smooth gradients with small noise, one row at ``hi`` and one column
    at 0: expandable, shifted and overflow pixels in one image."""
    y, x = np.mgrid[0:h, 0:w]
    base = (x + 2 * y) / (w + 2 * h) * hi
    imgs = np.clip(base[None] + rng.normal(0, 2.0, (b, h, w)), 0, hi)
    imgs = imgs.astype(dtype)
    imgs[:, h // 3, :] = hi
    imgs[:, :, w // 4] = 0
    return imgs


def _i32(v):
    return torch.tensor(np.asarray(v, dtype=np.int32))


def _port_two_pass(imgs, msgs, want, t, max_val):
    """Pass 0 then pass 1 through the wrappers (plain on the CPU)."""
    zero = torch.zeros(imgs.shape[0], dtype=torch.int32)
    want = _i32(want)
    img_t, msg_t = torch.from_numpy(imgs), torch.from_numpy(msgs)
    p0 = pk.pee_embed(img_t, msg_t, zero, want, 0, t, max_val)
    p1 = pk.pee_embed(p0[0], msg_t, p0[2], want - p0[2], 1, t, max_val)
    return p0, p1


@pytest.mark.parametrize("h,w,dtype", [
    (37, 53, np.uint8), (61, 47, np.uint16), (64, 64, np.uint16),
    (3, 3, np.uint8), (2, 7, np.uint8),
])
@pytest.mark.parametrize("parity", [0, 1])
def test_plain_ops_match_jax(h, w, dtype, parity):
    hi = 255 if dtype == np.uint8 else 4095
    img = _carriers(np.random.default_rng(h * w + parity), 1, h, w, dtype,
                    hi)[0]
    img_t = torch.from_numpy(img)
    np.testing.assert_array_equal(
        torch_pee.rhombus_predict(img_t).numpy(),
        np.asarray(jax_pee.rhombus_predict(img)))
    np.testing.assert_array_equal(
        torch_pee.parity_mask(h, w, parity).numpy(),
        np.asarray(jax_pee.parity_mask(h, w, parity)))
    # the passes' set rank: the band geometry of the whole image (row 0)
    in_set, set_rank = torch_pee._band_geometry(
        h, w, torch.zeros(1, dtype=torch.int32), h, parity)
    np.testing.assert_array_equal(in_set[0].numpy(),
                                  np.asarray(jax_pee.parity_mask(h, w, parity)))
    np.testing.assert_array_equal(
        set_rank[0].numpy(), np.asarray(jax_pee._set_rank(h, w, parity)))
    for t in (1, 2, 5):
        assert int(torch_pee.capacity(img_t, parity, t, hi)) == int(
            jax_pee.capacity(img, parity, t, hi))
    hist_t = torch_pee.capacity_histogram(img_t, parity, 128, hi).numpy()
    hist_j = np.asarray(jax_pee.capacity_histogram(img, parity, 128, hi))
    np.testing.assert_array_equal(hist_t, hist_j)
    np.testing.assert_array_equal(
        torch_pee.capacities_by_threshold(hist_t),
        jax_pee.capacities_by_threshold(hist_j))
    # a batch of two bins each image on its own
    both = torch_pee.capacity_histogram(
        torch.stack([img_t, img_t.flip(0)]), parity, 128, hi).numpy()
    np.testing.assert_array_equal(both[0], hist_j)
    np.testing.assert_array_equal(
        both[1], np.asarray(jax_pee.capacity_histogram(img[::-1], parity,
                                                        128, hi)))


@pytest.mark.parametrize("dtype,hi", [(np.uint8, 255), (np.uint16, 4095)])
@pytest.mark.parametrize("parity", [0, 1])
@pytest.mark.parametrize("t_max", [8, 64])
def test_error_histogram_matches_jax(dtype, hi, parity, t_max):
    """``error_histogram`` (a bincount) equals the JAX package's (a sort)
    on seeded carriers, errors past +-t_max clamped into the end bins."""
    img = _carriers(np.random.default_rng(t_max + parity), 1, 45, 38, dtype,
                    hi)[0]
    got = torch_pee.error_histogram(torch.from_numpy(img), parity, t_max)
    want = np.asarray(jax_pee.error_histogram(jnp.asarray(img), parity,
                                              t_max))
    assert got.dtype == torch.int32 and got.shape == (2 * t_max + 1,)
    np.testing.assert_array_equal(got.numpy(), want)
    # the end bins hold the clamped errors
    assert want[0] > 0 and want[-1] > 0
    both = torch_pee.error_histogram(
        torch.from_numpy(np.stack([img, img[::-1].copy()])), parity, t_max)
    np.testing.assert_array_equal(both[0].numpy(), want)
    np.testing.assert_array_equal(
        both[1].numpy(),
        np.asarray(jax_pee.error_histogram(jnp.asarray(img[::-1]), parity,
                                           t_max)))


def test_capacities_by_threshold_is_a_copy():
    assert same_code(torch_pee.capacities_by_threshold,
                     jax_pee.capacities_by_threshold)


def _check_against_xla(imgs, msgs, want, t, max_val, out_lens):
    """The port's two plain passes and their inversions, image by image
    against the XLA ``embed_pass``/``extract_pass``."""
    p0, p1 = _port_two_pass(imgs, msgs, want, t, max_val)
    over = p0[1] | p1[1]
    ex1 = {n: pk.pee_extract(p1[0], over, p1[3], 1, t, n) for n in out_lens}
    for i in range(imgs.shape[0]):
        s0, o0, u0, n0 = jax_pee.embed_pass(
            imgs[i], msgs[i], np.int32(0), np.int32(want[i]), 0, t, max_val)
        s1, o1, u1, n1 = jax_pee.embed_pass(
            np.asarray(s0), msgs[i], np.int32(int(u0)),
            np.int32(want[i] - int(u0)), 1, t, max_val)
        for got, ref in ((p0, (s0, o0, u0, n0)), (p1, (s1, o1, u1, n1))):
            np.testing.assert_array_equal(got[0][i].numpy(), np.asarray(ref[0]))
            np.testing.assert_array_equal(got[1][i].numpy().astype(bool),
                                          np.asarray(ref[1]))
            assert int(got[2][i]) == int(ref[2])
            assert int(got[3][i]) == int(ref[3])
        assert int(p0[4][i]) == int(jax_pee.capacity(imgs[i], 0, t, max_val))
        assert int(p1[4][i]) == int(jax_pee.capacity(np.asarray(s0), 1, t,
                                                     max_val))
        over_i = np.asarray(o0) | np.asarray(o1)
        for n, (r1, b1, m1) in ex1.items():
            jr1, jb1, jm1 = jax_pee.extract_pass(
                np.asarray(s1), over_i, np.int32(int(n1)), 1, t, max_val, n)
            np.testing.assert_array_equal(r1[i].numpy(), np.asarray(jr1))
            np.testing.assert_array_equal(b1[i].numpy(), np.asarray(jb1))
            assert int(m1[i]) == int(jm1)
            r0, b0, m0 = pk.pee_extract(r1, over, p0[3], 0, t, n)
            jr0, jb0, jm0 = jax_pee.extract_pass(
                np.asarray(jr1), over_i, np.int32(int(n0)), 0, t, max_val, n)
            np.testing.assert_array_equal(r0[i].numpy(), np.asarray(jr0))
            np.testing.assert_array_equal(r0[i].numpy(), imgs[i])
            np.testing.assert_array_equal(b0[i].numpy(), np.asarray(jb0))
            assert int(m0[i]) == int(jm0)


_CFGS = [(np.uint16, 4095, 2), (np.uint8, 255, 4)]
_IDS = ["u16-T2", "u8-T4"]


def _wants(imgs, t, max_val):
    """want = 0, under pass-0 capacity, and past both passes (saturated)."""
    cap0 = [int(jax_pee.capacity(im, 0, t, max_val)) for im in imgs]
    return np.array([0, cap0[1] // 3, 10 ** 6], dtype=np.int64)


@pytest.mark.parametrize("dtype,max_val,t", _CFGS, ids=_IDS)
def test_plain_kernels_match_xla(dtype, max_val, t):
    rng = np.random.default_rng(7 + t)
    imgs = _carriers(rng, 3, 512, 128, dtype, max_val)
    msgs = rng.integers(0, 2, (3, 8192)).astype(np.uint8)
    _check_against_xla(imgs, msgs, _wants(imgs, t, max_val), t, max_val,
                       out_lens=(8, 4096))


@pytest.mark.parametrize("h,w,dtype", [(37, 53, np.uint8),
                                       (61, 47, np.uint16)])
def test_plain_kernels_match_xla_odd_geometry(h, w, dtype):
    max_val = 255 if dtype == np.uint8 else 4095
    rng = np.random.default_rng(h * w)
    imgs = _carriers(rng, 3, h, w, dtype, max_val)
    msgs = rng.integers(0, 2, (3, 1024)).astype(np.uint8)
    _check_against_xla(imgs, msgs, _wants(imgs, 2, max_val), 2, max_val,
                       out_lens=(1024,))


@pytest.mark.parametrize("dtype,max_val,t", _CFGS, ids=_IDS)
def test_plain_kernels_match_pallas(dtype, max_val, t):
    rng = np.random.default_rng(17 + t)
    b, h, w = 3, 512, 128
    n = h * w
    imgs = _carriers(rng, b, h, w, dtype, max_val)
    # n bits: no message index reaches past the end, where the Pallas
    # window reads zero padding and the XLA gather clamps to the last bit
    msgs = rng.integers(0, 2, (b, n)).astype(np.uint8)
    want = _wants(imgs, t, max_val)
    p0, p1 = _port_two_pass(imgs, msgs, want, t, max_val)

    msg2d, l2 = pp.prep_messages(msgs, n)
    msg2d = jnp.asarray(msg2d)
    want_j = jnp.asarray(want.astype(np.int32))
    s0, o0, u0, n0 = pp.embed_pass_batch(
        jnp.asarray(imgs).reshape(b, n // 128, 128), msg2d,
        jnp.zeros(b, jnp.int32), want_j, h, w, 0, t, max_val, l2)
    s1, o1, u1, n1 = pp.embed_pass_batch(
        s0, msg2d, u0, want_j - u0, h, w, 1, t, max_val, l2)
    for got, ref in ((p0, (s0, o0, u0, n0)), (p1, (s1, o1, u1, n1))):
        np.testing.assert_array_equal(
            got[0].numpy(), np.asarray(ref[0]).reshape(b, h, w))
        np.testing.assert_array_equal(
            got[1].numpy(), np.asarray(ref[1]).reshape(b, h, w))
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
        np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))

    over = p0[1] | p1[1]
    over_j = jnp.asarray(over.numpy().reshape(b, n // 128, 128))
    r1, segs1, cnts1 = pp.extract_pass_batch(s1, over_j, n1, h, w, 1, t,
                                             max_val)
    r0, segs0, cnts0 = pp.extract_pass_batch(r1, over_j, n0, h, w, 0, t,
                                             max_val)
    for out_len in (8, 4096):
        q1 = pk.pee_extract(p1[0], over, p1[3], 1, t, out_len)
        q0 = pk.pee_extract(q1[0], over, p0[3], 0, t, out_len)
        for q, r, segs, cnts in ((q1, r1, segs1, cnts1),
                                 (q0, r0, segs0, cnts0)):
            np.testing.assert_array_equal(
                q[0].numpy(), np.asarray(r).reshape(b, h, w))
            np.testing.assert_array_equal(
                q[1].numpy(), pp.collect_bits(segs, cnts, out_len))
            np.testing.assert_array_equal(
                q[2].numpy(), np.asarray(cnts).sum(axis=1))
        np.testing.assert_array_equal(q0[0].numpy(), imgs)


@pytest.mark.parametrize("shape", stress.SHAPES, ids=[s[0] for s in
                                                     stress.SHAPES])
def test_plain_k3_matches_xla_on_lookback_stress_cases(shape):
    """The stress cases that hold K3's look-back on the card
    (``tests/torch_pee_stress.py``) through the port's plain K3 and the XLA
    ``embed_pass``, image by image. Tile boundaries of 4,096 pixels (K3's
    tile on the card; here they only place the wants)."""
    imgs, msgs, base = stress.inputs(shape)
    max_val, t = shape[5], 2
    img_t = torch.from_numpy(imgs)
    msg_t, base_t = torch.from_numpy(msgs), torch.from_numpy(base)
    for parity in (0, 1):
        for label, want in stress.wants(img_t, parity, t, max_val, 4096):
            got = pk.pee_embed(img_t, msg_t, base_t, want, parity, t, max_val)
            for i in range(imgs.shape[0]):
                ref = jax_pee.embed_pass(imgs[i], msgs[i], np.int32(base[i]),
                                         np.int32(want[i]), parity, t,
                                         max_val)
                np.testing.assert_array_equal(got[0][i].numpy(),
                                              np.asarray(ref[0]))
                np.testing.assert_array_equal(got[1][i].numpy().astype(bool),
                                              np.asarray(ref[1]))
                assert int(got[2][i]) == int(ref[2]), label
                assert int(got[3][i]) == int(ref[3]), label
                assert int(got[4][i]) == int(
                    jax_pee.capacity(imgs[i], parity, t, max_val))


@pytest.mark.parametrize("shape", stress.SHAPES, ids=[s[0] for s in
                                                     stress.SHAPES])
def test_plain_k4_matches_xla_on_lookback_stress_cases(shape):
    """The stress cases that hold K4's look-back on the card
    (``tests/torch_pee_stress.py``) through the port's plain K4 and the XLA
    ``extract_pass``, image by image: K3's output at want ``cap`` with
    ``out_len`` and ``nproc`` at and beside 4,096-pixel tile boundaries,
    and forged stego and overflow bytes with ``nproc`` at set ranks that
    straddle them."""
    imgs, msgs, base = stress.inputs(shape)
    max_val, t = shape[5], 2
    b, h, w = imgs.shape
    img_t = torch.from_numpy(imgs)
    forged = tuple(torch.from_numpy(a) for a in stress.forged(shape, t))
    for parity in (0, 1):
        wants = stress.wants(img_t, parity, t, max_val, 4096)
        stego, over, used, nproc, _ = pk.pee_embed(
            img_t, torch.from_numpy(msgs), torch.from_numpy(base),
            dict(wants)["cap"], parity, t, max_val)
        cases = [(label, stego, over, np_, out_len) for label, np_, out_len
                 in stress.extract_cases(wants, used, nproc, h, w)]
        cases += [(label, *forged, torch.full((b,), v, dtype=torch.int32),
                   h * w // 2 + 1)
                  for label, v in stress.set_rank_nprocs(h, w, parity, 4096)]
        for label, st, ov, np_, out_len in cases:
            got = pk.pee_extract(st, ov, np_, parity, t, out_len)
            for i in range(b):
                ref = jax_pee.extract_pass(st[i].numpy(), ov[i].numpy() != 0,
                                           np.int32(np_[i]), parity, t,
                                           max_val, out_len)
                np.testing.assert_array_equal(got[0][i].numpy(),
                                              np.asarray(ref[0]))
                np.testing.assert_array_equal(got[1][i].numpy(),
                                              np.asarray(ref[1]))
                assert int(got[2][i]) == int(ref[2]), label


def test_message_index_clamps_to_the_buffer():
    """want = 2**30 with a short message reads its last bit, as the XLA
    ``jnp.take(..., mode="clip")`` does."""
    rng = np.random.default_rng(3)
    imgs = _carriers(rng, 1, 40, 40, np.uint8, 255)
    msgs = np.ones((1, 8), dtype=np.uint8)
    p0, _ = _port_two_pass(imgs, msgs, [1 << 30], 2, 255)
    s0, o0, u0, n0 = jax_pee.embed_pass(
        imgs[0], msgs[0], np.int32(0), np.int32(1 << 30), 0, 2, 255)
    np.testing.assert_array_equal(p0[0][0].numpy(), np.asarray(s0))
    assert int(p0[3][0]) == int(n0) == 40 * 40


@pytest.mark.parametrize("bad", ["dtype", "msg_rows", "want_dtype", "parity",
                                 "max_val", "t", "out_len", "overflow_shape"])
def test_wrappers_refuse_bad_arguments(bad):
    img = torch.zeros((2, 8, 8), dtype=torch.uint8)
    z = torch.zeros(2, dtype=torch.int32)
    embed = dict(imgs=img, msg=torch.zeros((2, 8), dtype=torch.uint8),
                 msg_base=z, want=z, parity=0, t=2, max_val=255)
    extract = dict(stego=img, overflow=torch.zeros_like(img), nproc=z,
                   parity=0, t=2, out_len=8)
    bad_args = {
        "dtype": (embed, "imgs", img.to(torch.int32)),
        "msg_rows": (embed, "msg", embed["msg"][:1]),
        "want_dtype": (embed, "want", z.to(torch.int64)),
        "parity": (embed, "parity", 2),
        # bounded by the 16-bit pixel arithmetic, not by the dtype: uint8
        # with BitsStored > 8 takes max_val up to 65535
        "max_val": (embed, "max_val", 1 << 16),
        "t": (extract, "t", 0),
        "out_len": (extract, "out_len", 0),
        "overflow_shape": (extract, "overflow", extract["overflow"][:, :4]),
    }
    args, key, value = bad_args[bad]
    args[key] = value
    call = pk.pee_embed if args is embed else pk.pee_extract
    with pytest.raises(ValueError):
        call(**args)


@pytest.mark.parametrize("bad", ["row0", "rows_past_height", "top_shape",
                                 "bottom_dtype", "counts_shape",
                                 "rank_base_dtype", "want_int32",
                                 "nproc_int32", "out_len"])
def test_band_wrappers_refuse_bad_arguments(bad):
    band = torch.zeros((1, 4, 8), dtype=torch.uint16)
    row = torch.zeros((1, 8), dtype=torch.uint16)
    counts = torch.zeros((1, 1), dtype=torch.int32)
    embed = dict(band=band, top=row, bottom=row, row0=2, height=6,
                 counts=counts, rank_base=None,
                 msg=torch.zeros((1, 8), dtype=torch.uint8), msg_base=0,
                 want=3, parity=0, t=2, max_val=4095)
    extract = dict(band=band, top=row, bottom=row, row0=2, height=6,
                   overflow=torch.zeros_like(band, dtype=torch.uint8),
                   nproc=5, parity=1, t=2, out_len=8)
    bad_args = {
        "row0": (embed, "row0", -1),
        "rows_past_height": (extract, "row0", 3),
        "top_shape": (embed, "top", row[:, :4]),
        "bottom_dtype": (extract, "bottom", row.to(torch.uint8)),
        "counts_shape": (embed, "counts", torch.zeros((1, 2),
                                                      dtype=torch.int32)),
        "rank_base_dtype": (embed, "rank_base", torch.zeros(1)),
        "want_int32": (embed, "want", 1 << 31),
        "nproc_int32": (extract, "nproc", -(1 << 31) - 1),
        "out_len": (extract, "out_len", 0),
    }
    args, key, value = bad_args[bad]
    pk.pee_embed_band(**embed)       # the good arguments pass
    pk.pee_extract_band(**extract)
    args[key] = value
    call = pk.pee_embed_band if args is embed else pk.pee_extract_band
    with pytest.raises(ValueError):
        call(**args)


def test_plain_runs_count_no_launch():
    profiling.get_profiler().reset()
    imgs = _carriers(np.random.default_rng(0), 2, 16, 16, np.uint8, 255)
    msgs = np.zeros((2, 8), dtype=np.uint8)
    _port_two_pass(imgs, msgs, [5, 9], 2, 255)
    band, row = torch.from_numpy(imgs[:1, 4:12]), torch.from_numpy(imgs[:1, 3])
    counts = pk.pee_count_band(band, row, row, 4, 16, 0, 2, 255)
    pk.pee_embed_band(band, row, row, 4, 16, counts, None,
                      torch.from_numpy(msgs[:1]), 0, 5, 0, 2, 255)
    over = torch.zeros_like(band)
    pk.pee_extract_count_band(band, row, row, 4, 16, over, 9, 0, 2)
    pk.pee_extract_band(band, row, row, 4, 16, over, 9, 0, 2, 8)
    assert set(profiling.launches(pk.KERNELS).values()) == {0}
