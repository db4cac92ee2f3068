"""Plain versions of the port's kernels K1 ``raster_embed`` and K2
``raster_extract`` against every formulation of the same functions in the
JAX package: the Pallas kernels (interpret mode on the CPU), the XLA
``embed``/``xor_maps_packed_batch``/``extract_message_device`` and the host
``extract_raster_host``; and K2's segment plan (``extract_segments``),
rebuilt in numpy, against the host extractor on the boundary plans of
``tests/torch_raster_cases.py``. All comparisons are exact.

The CUDA kernels themselves are held against these plain versions on the
GPU (``chip_smoke.py``, ``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from codec_tcc_tpu.ops import embed as jax_embed
from codec_tcc_tpu.ops import host_extract
from codec_tcc_tpu.ops import pallas_embed as pe
from codec_tcc_tpu.ops import segments as jax_segments
from codec_tcc_tpu_torch.ops import embed as torch_embed
from codec_tcc_tpu_torch.ops import raster_kernels as rk

import torch_raster_cases as rc

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _interpret_mode():
    from jax.experimental.pallas import tpu as pltpu

    if jax.default_backend() == "tpu":
        yield
        return
    with pltpu.force_tpu_interpret_mode():
        yield


def _real_plan(rng, n, nbits):
    """A plan as the pipelines make them (the ``_random_case`` plans of
    tests/test_pallas.py): planes >= s carry zero-length windows."""
    s = int(rng.integers(1, nbits + 1))
    plan = jax_segments.distribute_segments(s, int(rng.integers(0, 2 * n)))
    pp = jax_segments.raster_plane_plan(
        plan, n, nbits, int(rng.integers(0, n)), bool(rng.integers(0, 2))
    )
    bits = rng.integers(0, 2, plan.total_bits).astype(np.uint8)
    msg = jax_embed.pad_message(bits, n, int(pp.offsets.max(initial=0)))
    return s, pp.starts, pp.lengths, pp.offsets, msg


def _image(rng, h, w, dtype):
    hi = 256 if dtype == np.uint8 else 4096
    return rng.integers(0, hi, (h, w)).astype(dtype)


def _plain_k1(img, msg, starts, lens, offs, s, emit_maps):
    st, mp = rk.raster_embed(
        torch.from_numpy(img), torch.from_numpy(msg), starts, lens, offs, s,
        emit_maps=emit_maps,
    )
    return st.numpy(), None if mp is None else mp.numpy()


def _plain_k2(stego, starts, lens, offs, s, out_len):
    return rk.raster_extract(
        torch.from_numpy(np.array(stego)), starts, lens, offs, s, out_len
    ).numpy()


GEOMS = [(32, 128, np.uint16), (64, 64, np.uint16), (32, 128, np.uint8),
         (64, 64, np.uint8)]


@pytest.mark.parametrize("h,w,dtype", GEOMS)
def test_k1_matches_pallas_preplaced_and_xla(h, w, dtype):
    rng = np.random.default_rng(100)
    n = h * w
    nbits = 8 if dtype == np.uint16 else 4
    img = _image(rng, h, w, dtype)
    s, starts, lens, offs, msg = _real_plan(rng, n, nbits)

    stego, maps = _plain_k1(img, msg, starts, lens, offs, s, True)

    xla = np.asarray(jax_embed.embed(img, msg, starts, lens, offs,
                                     np.int32(s), nbits))
    np.testing.assert_array_equal(stego, xla)

    bits4 = pe.preplace_bits(msg[None], starts[None], lens[None], offs[None], n)
    pallas = np.asarray(pe.embed_batch_preplaced(
        jnp.asarray(img).reshape(1, n // 128, 128), jnp.asarray(bits4),
        jnp.asarray(starts[None]), jnp.asarray(lens[None]), nbits,
        pe.pick_tile(n),
    )).reshape(h, w)
    np.testing.assert_array_equal(stego, pallas)

    want_maps = np.asarray(jax_embed.xor_maps_packed_batch(
        jnp.asarray(img)[None], jnp.asarray(xla)[None], s))[0]
    np.testing.assert_array_equal(maps, want_maps)


def _special_plans(n):
    """Plans the pipelines reach only at the edges: windows wrapping past
    the raster end, a plane covering all N pixels, s below the plane count
    with nonzero lengths on the planes past s."""
    return [
        # wrap-around windows on every plane
        (3, [n - 5, n - 100, n // 2, 0], [40, 300, n - 7, 0],
         [0, 40, 340, 0]),
        # len == N on plane 0, wrapping start
        (2, [n // 3, 17, 0, 0], [n, n // 2, 0, 0], [0, n, 0, 0]),
        # s < NP with nonzero windows past s (must stay untouched)
        (1, [7, n - 3, 11, 5], [n // 4, 50, 9, n], [3, 9, 100, 0]),
        # every plane at full width, aligned, all active
        (4, [0, 0, 0, 0], [n, n, n, n], [0, n, 2 * n, 3 * n]),
    ]


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("case", range(4))
def test_k1_special_plans_match_xla(dtype, case):
    rng = np.random.default_rng(7 + case)
    h, w = 32, 128
    n = h * w
    s, starts, lens, offs = _special_plans(n)[case]
    starts, lens, offs = (np.asarray(v, np.int32) for v in (starts, lens, offs))
    img = _image(rng, h, w, dtype)
    msg = jax_embed.pad_message(
        rng.integers(0, 2, 4 * n).astype(np.uint8), n, int(offs.max())
    )
    stego, maps = _plain_k1(img, msg, starts, lens, offs, s, True)
    xla = np.asarray(jax_embed.embed(img, msg, starts, lens, offs,
                                     np.int32(s), 4))
    np.testing.assert_array_equal(stego, xla)
    want_maps = np.asarray(jax_embed.xor_maps_packed_batch(
        jnp.asarray(img)[None], jnp.asarray(xla)[None], s))[0]
    np.testing.assert_array_equal(maps, want_maps)
    # planes >= s are never touched
    keep = np.array(sum(1 << p for p in range(s)), dtype)
    np.testing.assert_array_equal(stego & ~keep, img & ~keep)


def test_k1_reads_zero_past_message_end():
    """K1 bounds-checks the message instead of relying on pad_message's
    slack: an unpadded message embeds like its zero-padded form."""
    rng = np.random.default_rng(3)
    h, w = 32, 128
    n = h * w
    img = _image(rng, h, w, np.uint16)
    starts = np.array([5, 0, 0, 0], np.int32)
    lens = np.array([n, 0, 0, 0], np.int32)
    offs = np.zeros(4, np.int32)
    short = rng.integers(0, 2, 100).astype(np.uint8)
    st_short, _ = _plain_k1(img, short, starts, lens, offs, 1, False)
    padded = torch_embed.pad_message(short, n, 0)
    np.testing.assert_array_equal(padded, jax_embed.pad_message(short, n, 0))
    st_pad, _ = _plain_k1(img, padded, starts, lens, offs, 1, False)
    np.testing.assert_array_equal(st_short, st_pad)


K1_LABELS = [plan[0] for plan in rc.k1_plans(64 * 64)]


@pytest.mark.parametrize("h,w", [(64, 64), (40, 41)])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("label", K1_LABELS)
def test_k1_plans_match_xla(label, dtype, h, w):
    """The plain K1 equals the JAX package's ``embed`` +
    ``xor_maps_packed_batch`` on every K1 plan (window starts, ends and
    message offsets at every residue mod 16, wraps mid-chunk, windows
    longer than N, past-s planes, aliased offsets, starts >= N, sixteen
    planes at s = 12, the message ending mid-chunk), with maps (N/8 odd at
    40x41). The plain K1 reads the message cut at its length; the JAX
    package reads it zero-padded (``pad_message``). On uint8 the JAX
    ``embed`` takes at most 8 planes, as ``pipeline`` clamps them: planes 8
    and up change nothing there, and their map rows are zero."""
    n = h * w
    plans = rc.k1_plans(n, seed=n)
    _, s, starts, lens, offs, msg_len = next(p for p in plans
                                             if p[0] == label)
    rng = np.random.default_rng(len(label) + n)
    img = _image(rng, h, w, dtype)
    msg = rng.integers(0, 2, msg_len).astype(np.uint8)
    stego, maps = _plain_k1(img, msg, starts, lens, offs, s, True)

    # one padded length for every plan of the shape: one JAX compile each
    pad_off = max(max(p[4]) for p in plans)
    nbits = min(len(starts), 8 * np.dtype(dtype).itemsize)
    st, ln, of = (np.asarray(v, np.int64)[:nbits].astype(np.int32)
                  for v in (np.asarray(starts) % n, lens, offs))
    xla = np.asarray(jax_embed.embed(
        img, jax_embed.pad_message(msg, n, pad_off), st, ln, of,
        np.int32(s), nbits))
    np.testing.assert_array_equal(stego, xla)
    want_maps = np.asarray(jax_embed.xor_maps_packed_batch(
        jnp.asarray(img)[None], jnp.asarray(xla)[None], s))[0]
    np.testing.assert_array_equal(maps, want_maps)


@pytest.mark.parametrize("h,w,dtype", GEOMS)
def test_k2_matches_pallas_raster_extract_and_host(h, w, dtype):
    rng = np.random.default_rng(200)
    n = h * w
    nbits = 8 if dtype == np.uint16 else 4
    img = _image(rng, h, w, dtype)
    s, starts, lens, offs, msg = _real_plan(rng, n, nbits)
    stego = np.asarray(jax_embed.embed(img, msg, starts, lens, offs,
                                       np.int32(s), nbits))
    out_len = max(int((lens + offs).max(initial=0)), 1)

    got = _plain_k2(stego, starts, lens, offs, s, out_len)

    rows = pe.extract_raster_batch(
        jnp.asarray(stego).reshape(1, n // 128, 128),
        jnp.asarray(starts[None]), jnp.asarray(lens[None]), nbits,
        pe.pick_tile(n),
    )
    pallas = pe.assemble_raster(np.asarray(rows), starts[None], lens[None],
                                offs[None], out_len)[0]
    np.testing.assert_array_equal(got, pallas)
    host = host_extract.extract_raster_host(stego, starts, lens, offs, s,
                                            out_len)
    np.testing.assert_array_equal(got, host)
    xla = np.asarray(jax_embed.extract_message_device(
        stego, starts, lens, offs, np.int32(s), nbits, out_len))
    np.testing.assert_array_equal(got, xla)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("case", range(4))
def test_k2_degenerate_plans_match_host(dtype, case):
    rng = np.random.default_rng(30 + case)
    h, w = 64, 64
    n = h * w
    _, s, starts, lens, offs, out_len = rc.degenerate_plans(n)[case]
    starts, lens, offs = (np.asarray(v, np.int32) for v in (starts, lens, offs))
    stego = _image(rng, h, w, dtype)
    got = _plain_k2(stego, starts, lens, offs, s, out_len)
    host = host_extract.extract_raster_host(stego, starts, lens, offs, s,
                                            out_len)
    np.testing.assert_array_equal(got, host)
    xla = np.asarray(jax_embed.extract_message_device(
        stego, starts, lens, offs, np.int32(s), 4, out_len))
    np.testing.assert_array_equal(got, xla)


def test_k2_start_taken_mod_n():
    """Untrusted containers may carry starts >= N; K2 reduces them mod N
    like the host extractor."""
    rng = np.random.default_rng(5)
    stego = _image(rng, 32, 128, np.uint16)
    n = stego.size
    _, s, starts, lens, offs, out_len = rc.start_mod_n_plan(n)
    starts, lens, offs = (np.asarray(v, np.int64) for v in (starts, lens, offs))
    got = _plain_k2(stego, starts, lens, offs, s, out_len)
    host = host_extract.extract_raster_host(stego, starts, lens, offs, s,
                                            out_len)
    np.testing.assert_array_equal(got, host)


def _from_segments(stego, begin, pos, plane):
    """numpy: the payload bits K2 builds from its resolved segments."""
    flat = np.ascontiguousarray(stego).ravel()
    out = np.zeros(int(begin[-1]), np.uint8)
    for k in range(plane.size):
        lo, hi = int(begin[k]), int(begin[k + 1])
        if plane[k] >= 0:
            out[lo:hi] = (flat[pos[k]:pos[k] + hi - lo] >> plane[k]) & 1
    return out


def _check_segments(begin, pos, plane, n, out_len, pixel_bits):
    """The table K2's launch accepts (csrc/raster_extract.cu)."""
    assert 1 <= plane.size <= rk.MAX_SEGMENTS
    assert begin.size == plane.size + 1 == pos.size + 1
    assert begin[0] == 0 and begin[-1] == out_len
    seg_len = np.diff(begin.astype(np.int64))
    assert (seg_len > 0).all()
    assert ((plane >= -1) & (plane < pixel_bits)).all()
    read = plane >= 0
    assert (pos[read] >= 0).all() and (pos[read] + seg_len[read] <= n).all()


K2_LABELS = [plan[0] for plan in rc.boundary_plans(64 * 64)]


@pytest.mark.parametrize("h,w", [(64, 64), (37, 53)])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("label", K2_LABELS)
def test_k2_segments_rebuild_host_extract(label, dtype, h, w):
    """The segment plan K2 runs on, rebuilt in numpy, equals the JAX
    package's host extractor and the plain K2 on every boundary plan:
    segment ends at each residue mod 16, wraps mid-chunk, odd starts,
    aliased and past-s windows, windows longer than N, starts >= N and
    ``out_len`` 1, 15, 16, 17 and past every window."""
    n = h * w
    plans = {plan[0]: plan for plan in rc.boundary_plans(n)}
    _, s, starts, lens, offs, out_len = plans[label]
    stego = _image(np.random.default_rng(len(label)), h, w, dtype)
    bits = 8 * np.dtype(dtype).itemsize
    begin, pos, plane = rk.extract_segments(starts, lens, offs, s, n,
                                            out_len, bits)
    _check_segments(begin, pos, plane, n, out_len, bits)
    got = _from_segments(stego, begin, pos, plane)
    host = host_extract.extract_raster_host(stego, starts, lens, offs, s,
                                            out_len)
    np.testing.assert_array_equal(got, host)
    np.testing.assert_array_equal(
        got, _plain_k2(stego, starts, lens, offs, s, out_len))


@pytest.mark.parametrize("h,w,dtype", GEOMS)
def test_k2_segments_of_real_plans(h, w, dtype):
    """Plans as the pipelines make them resolve to few segments, each a
    whole window piece, and rebuild the host extractor's bits."""
    rng = np.random.default_rng(300)
    n = h * w
    nbits = 8 if dtype == np.uint16 else 4
    stego = _image(rng, h, w, dtype)
    for _ in range(5):
        s, starts, lens, offs, _ = _real_plan(rng, n, nbits)
        out_len = max(int((lens + offs).max(initial=0)), 1)
        begin, pos, plane = rk.extract_segments(starts, lens, offs, s, n,
                                                out_len, 8 * stego.itemsize)
        _check_segments(begin, pos, plane, n, out_len, 8 * stego.itemsize)
        assert plane.size <= 2 * nbits + 1
        np.testing.assert_array_equal(
            _from_segments(stego, begin, pos, plane),
            host_extract.extract_raster_host(stego, starts, lens, offs, s,
                                             out_len))


def test_k2_segments_fit_the_table_at_worst():
    """Sixteen planes, each longer than N, wrapping and at staggered
    offsets, cut message order four times each: 65 segments, the size of
    the launch's table."""
    n = 1000
    starts = [7 + 13 * p for p in range(16)]
    lens = [n + 50 + p for p in range(16)]
    offs = [1 + 3 * p for p in range(16)]
    out_len = 2 * n + 100
    begin, pos, plane = rk.extract_segments(starts, lens, offs, 16, n,
                                            out_len, 16)
    _check_segments(begin, pos, plane, n, out_len, 16)
    stego = _image(np.random.default_rng(1), 10, 100, np.uint16)
    np.testing.assert_array_equal(
        _from_segments(stego, begin, pos, plane),
        host_extract.extract_raster_host(stego, starts, lens, offs, 16,
                                         out_len))
    with pytest.raises(ValueError, match="int32"):
        rk.extract_segments(starts, lens, offs, 16, n, 1 << 31, 16)


def test_wrappers_on_cpu_run_plain_and_count_no_launch():
    rk.reset_launch_counts()
    rng = np.random.default_rng(9)
    img = torch.from_numpy(_image(rng, 32, 128, np.uint16))
    msg = torch.from_numpy(rng.integers(0, 2, 5000).astype(np.uint8))
    plan = ([3, 0, 0, 0], [1000, 0, 0, 0], [0, 0, 0, 0])
    stego, maps = rk.raster_embed(img, msg, *plan, 1, emit_maps=True)
    want, want_maps = rk.raster_embed_plain(img, msg, *plan, 1, emit_maps=True)
    assert torch.equal(stego, want) and torch.equal(maps, want_maps)
    assert maps.shape == (1, img.numel() // 8) and maps.dtype == torch.uint8
    bits = rk.raster_extract(stego, *plan, 1, 1000)
    assert torch.equal(bits, msg[:1000])
    assert set(rk.LAUNCHES.values()) == {0}


def test_wrappers_reject_other_devices_and_bad_plans():
    meta_img = torch.empty((8, 8), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        rk.raster_embed(meta_img, torch.empty(1, dtype=torch.uint8),
                        [0], [1], [0], 1, emit_maps=False)
    with pytest.raises(ValueError, match="cuda or cpu"):
        rk.raster_extract(meta_img, [0], [1], [0], 1, 4)
    img = torch.zeros((8, 8), dtype=torch.uint16)
    msg = torch.zeros(64, dtype=torch.uint8)
    with pytest.raises(ValueError, match="planes"):
        rk.raster_embed(img, msg, [0] * 17, [0] * 17, [0] * 17, 1,
                        emit_maps=False)
    with pytest.raises(ValueError, match="cut point"):
        rk.raster_embed(img, msg, [0], [1], [0], 2, emit_maps=False)
    with pytest.raises(ValueError, match=">= 0"):
        rk.raster_extract(img, [0], [-1], [0], 1, 4)
    with pytest.raises(ValueError, match="int32"):
        rk.raster_extract(img, [0], [1], [(1 << 31) - 10], 1, 4)
    with pytest.raises(ValueError, match="out_len"):
        rk.raster_extract(img, [0], [1], [0], 1, 0)


# ---------------------------------------------------------------------------
# the batch axis: raster_embed_batch / raster_extract_batch (plain versions)
# ---------------------------------------------------------------------------


def _batch_case(seed, b, h, w, dtype, nbits=4):
    """A batch as the planners make it: per-image cut points, payload
    lengths and hybrid starts (planes >= s carry zero-length windows)."""
    rng = np.random.default_rng(seed)
    n = h * w
    imgs = np.stack([_image(rng, h, w, dtype) for _ in range(b)])
    starts, lens, offs = (np.zeros((b, nbits), np.int32) for _ in range(3))
    svals = np.zeros(b, np.int32)
    bits = []
    for i in range(b):
        s = 1 + (i % nbits)
        svals[i] = s
        plan = jax_segments.distribute_segments(
            s, int(rng.integers(1, min(2 * n, s * n))))
        pp = jax_segments.raster_plane_plan(
            plan, n, nbits, int(rng.integers(0, n)), bool(i % 2))
        starts[i], lens[i], offs[i] = pp.starts, pp.lengths, pp.offsets
        bits.append(rng.integers(0, 2, plan.total_bits).astype(np.uint8))
    lpad = max(int((offs + n).max()), max(x.size for x in bits))
    msgs = np.zeros((b, lpad), np.uint8)
    for i, x in enumerate(bits):
        msgs[i, :x.size] = x
    return imgs, msgs, starts, lens, offs, svals


def _plain_k1_batch(imgs, msgs, starts, lens, offs, svals, max_s=None):
    st, mp = rk.raster_embed_batch(
        torch.from_numpy(imgs), torch.from_numpy(msgs), starts, lens, offs,
        svals, emit_maps=imgs[0].size % 8 == 0, max_s=max_s,
    )
    return st.numpy(), None if mp is None else mp.numpy()


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_k1_batch_matches_pallas_embed_batch_and_preplaced(dtype):
    """B = 3 with differing cut points and payload lengths: the plain
    batch K1 equals the windowed Pallas ``embed_batch`` and
    ``embed_batch_preplaced`` (interpret mode) image for image, and its
    maps are ``xor_maps_packed_batch`` over the largest cut point (rows
    past each image's own cut point zero)."""
    b, h, w, nbits = 3, 32, 128, 4
    n = h * w
    imgs, msgs, starts, lens, offs, svals = _batch_case(11, b, h, w, dtype)
    stego, maps = _plain_k1_batch(imgs, msgs, starts, lens, offs, svals)

    tile = pe.pick_tile(n)
    msg2d, l2 = pe.shift_messages_2d(msgs, n)
    windowed = np.asarray(pe.embed_batch(
        jnp.asarray(imgs).reshape(b, n // 128, 128), jnp.asarray(msg2d),
        jnp.asarray(starts), jnp.asarray(lens), jnp.asarray(offs), nbits,
        tile, l2,
    )).reshape(b, h, w)
    np.testing.assert_array_equal(stego, windowed)
    bits4 = pe.preplace_bits(msgs, starts, lens, offs, n)
    preplaced = np.asarray(pe.embed_batch_preplaced(
        jnp.asarray(imgs).reshape(b, n // 128, 128), jnp.asarray(bits4),
        jnp.asarray(starts), jnp.asarray(lens), nbits, tile,
    )).reshape(b, h, w)
    np.testing.assert_array_equal(stego, preplaced)

    max_s = int(svals.max())
    want_maps = np.asarray(jax_embed.xor_maps_packed_batch(
        jnp.asarray(imgs), jnp.asarray(stego), max_s))
    np.testing.assert_array_equal(maps, want_maps)
    for i in range(b):
        assert not maps[i, svals[i]:].any()
        single, single_maps = _plain_k1(imgs[i], msgs[i], starts[i], lens[i],
                                        offs[i], int(svals[i]), True)
        np.testing.assert_array_equal(stego[i], single)
        np.testing.assert_array_equal(maps[i, :svals[i]], single_maps)
    # more map rows than the largest cut point: zeros
    _, wide = _plain_k1_batch(imgs, msgs, starts, lens, offs, svals,
                              max_s=max_s + 2)
    np.testing.assert_array_equal(wide[:, :max_s], maps)
    assert not wide[:, max_s:].any()


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_k1_k2_batch_odd_geometry_match_pallas_padded(dtype):
    """An odd N (50x100: no tile divides it) runs the Pallas preplaced
    kernels on the zero-padded flat buffer with split windows (wpp = 2);
    the plain batch K1 and K2 equal them, a wrapping window included."""
    b, h, w, nbits = 3, 50, 100, 4
    n = h * w
    assert pe.pick_tile(n) == 0
    imgs, msgs, starts, lens, offs, svals = _batch_case(12, b, h, w, dtype)
    starts[0, 0], lens[0, 0] = n - 70, 200            # wraps
    n_buf, tile = pe.padded_flat(n)
    stego, _ = _plain_k1_batch(imgs, msgs, starts, lens, offs, svals)

    bits4 = np.asarray(pe.preplace_bits_device(
        jnp.asarray(msgs), jnp.asarray(starts), jnp.asarray(lens),
        jnp.asarray(offs), n, nbits, n_buf,
    ))
    st2, ln2 = pe.split_windows(starts, lens, n)
    flat = jnp.pad(jnp.asarray(imgs).reshape(b, n), ((0, 0), (0, n_buf - n)))
    pallas = np.asarray(pe.embed_batch_preplaced(
        flat.reshape(b, n_buf // 128, 128), jnp.asarray(bits4),
        jnp.asarray(st2), jnp.asarray(ln2), nbits, tile, 2,
    )).reshape(b, n_buf)[:, :n].reshape(b, h, w)
    np.testing.assert_array_equal(stego, pallas)

    out_len = int((offs + lens).max())
    got = rk.raster_extract_batch(torch.from_numpy(stego), starts, lens,
                                  offs, svals, out_len).numpy()
    sflat = jnp.pad(jnp.asarray(stego).reshape(b, n),
                    ((0, 0), (0, n_buf - n)))
    rows = pe.extract_raster_batch(
        sflat.reshape(b, n_buf // 128, 128), jnp.asarray(st2),
        jnp.asarray(ln2), nbits, tile, 2,
    ).reshape(b, nbits, n_buf)[:, :, :n]
    want = pe.assemble_raster(np.asarray(rows), starts, lens, offs, out_len)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_k2_batch_matches_pallas_extract_raster_batch(dtype):
    """The plain batch K2 equals ``extract_raster_batch`` +
    ``assemble_raster`` and the host extractor, image for image, at an
    ``out_len`` past every window and at one inside them."""
    b, h, w, nbits = 3, 32, 128, 4
    n = h * w
    imgs, msgs, starts, lens, offs, svals = _batch_case(13, b, h, w, dtype)
    stego, _ = _plain_k1_batch(imgs, msgs, starts, lens, offs, svals)
    rows = pe.extract_raster_batch(
        jnp.asarray(stego).reshape(b, n // 128, 128), jnp.asarray(starts),
        jnp.asarray(lens), nbits, pe.pick_tile(n),
    )
    for out_len in (int((offs + lens).max()), 100):
        got = rk.raster_extract_batch(torch.from_numpy(stego), starts, lens,
                                      offs, svals, out_len).numpy()
        want = pe.assemble_raster(np.asarray(rows), starts, lens, offs,
                                  out_len)
        np.testing.assert_array_equal(got, want)
        for i in range(b):
            np.testing.assert_array_equal(got[i], host_extract.extract_raster_host(
                stego[i], starts[i], lens[i], offs[i], int(svals[i]), out_len))
            np.testing.assert_array_equal(got[i], _plain_k2(
                stego[i], starts[i], lens[i], offs[i], int(svals[i]),
                out_len))


def test_batch_wrappers_on_cpu_run_plain_and_check_plans():
    rk.reset_launch_counts()
    imgs, msgs, starts, lens, offs, svals = _batch_case(14, 2, 16, 16,
                                                        np.uint16)
    timgs, tmsgs = torch.from_numpy(imgs), torch.from_numpy(msgs)
    st, mp = rk.raster_embed_batch(timgs, tmsgs, starts, lens, offs, svals,
                                   emit_maps=True)
    want, want_mp = rk.raster_embed_batch_plain(
        timgs, tmsgs, starts, lens, offs, svals, emit_maps=True)
    assert torch.equal(st, want) and torch.equal(mp, want_mp)
    assert mp.shape == (2, int(svals.max()), 32)
    bits = rk.raster_extract_batch(st, starts, lens, offs, svals, 64)
    assert bits.shape == (2, 64) and bits.dtype == torch.uint8
    assert set(rk.LAUNCHES.values()) == {0}
    with pytest.raises(ValueError, match=r"\(B, NP\)"):
        rk.raster_embed_batch(timgs, tmsgs, starts[:1], lens[:1], offs[:1],
                              svals[:1], emit_maps=False)
    with pytest.raises(ValueError, match="max_s"):
        rk.raster_embed_batch(timgs, tmsgs, starts, lens, offs, svals,
                              emit_maps=True, max_s=int(svals.max()) - 1)
    with pytest.raises(ValueError, match="cut point"):
        rk.raster_extract_batch(st, starts, lens, offs, [0, 5], 8)
    meta = torch.empty((1, 8, 8), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        rk.raster_embed_batch(meta, torch.zeros((1, 8), dtype=torch.uint8),
                              [[0]], [[1]], [[0]], [1], emit_maps=False)
    with pytest.raises(ValueError, match="cuda or cpu"):
        rk.raster_extract_batch(meta, [[0]], [[1]], [[0]], [1], 4)
