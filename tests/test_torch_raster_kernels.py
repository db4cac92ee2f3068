"""Plain versions of the port's kernels K1 ``raster_embed`` and K2
``raster_extract`` against every formulation of the same functions in the
JAX package: the Pallas kernels (interpret mode on the CPU), the XLA
``embed``/``xor_maps_packed_batch``/``extract_message_device`` and the host
``extract_raster_host``. All comparisons are exact.

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


def _degenerate_extract_plans(n):
    """(s, starts, lens, offs, out_len): the reference's negative-size
    accident aliases two planes onto one message offset (the higher plane
    wins); a plane past s with a nonzero length writes zeros over its span
    (ops/host_extract.py:50-53); a window longer than N zero-fills past N."""
    return [
        (3, [10, n - 20, 300, 0], [500, 400, 200, 0], [0, 0, 450, 0], 800),
        (2, [0, 100, 50, 7], [300, 200, 250, 0], [0, 300, 100, 0], 700),
        (1, [n - 3, 0, 0, 0], [n + 40, 0, 0, 0], [5, 0, 0, 0], n + 100),
        (4, [1, 2, 3, 4], [64, 64, 64, 64], [0, 32, 32, 96], 160),
    ]


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("case", range(4))
def test_k2_degenerate_plans_match_host(dtype, case):
    rng = np.random.default_rng(30 + case)
    h, w = 64, 64
    n = h * w
    s, starts, lens, offs, out_len = _degenerate_extract_plans(n)[case]
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
    starts = np.array([n + 17, 3 * n - 1, 0, 0], np.int64)
    lens = np.array([100, 60, 0, 0], np.int64)
    offs = np.array([0, 100, 0, 0], np.int64)
    got = _plain_k2(stego, starts, lens, offs, 2, 160)
    host = host_extract.extract_raster_host(stego, starts, lens, offs, 2, 160)
    np.testing.assert_array_equal(got, host)


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
    assert rk.LAUNCHES == {"raster_embed": 0, "raster_extract": 0}


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
