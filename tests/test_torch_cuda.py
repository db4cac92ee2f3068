"""The port's CUDA kernels on a GPU: K1-K4, the batch forms of K1/K2 and
the band launches of K3/K4 against their plain versions; the deflate
kernels against host zlib, and the single-image encodes' use of them; the
inflate kernels against host zlib, the single-image decodes' use of them
and the host route of the streams they leave; the
raster, PEE, block_adaptive, container batch, tiled (one image across a
mesh of the card repeated) and ``dp`` (a batch split over such a mesh)
encode paths against the CPU path; the device block
extract against its host twin, and the batch block decode on the card
against the CPU's; the host embed route with no K1; the
``jls`` codec, v1 containers and the serving daemon against the parity
fixture. Marked ``cuda``: they skip where no GPU is present and run on the
GPU machine with

    python -m pytest tests/test_torch_cuda.py -m cuda -q

(this file imports no jax, so it runs where jax is not installed)."""

import numpy as np
import pytest
import torch

from codec_tcc_tpu_torch import profiling
import codec_tcc_tpu_torch as port
import torch_deflate_cases as dc
import torch_inflate_cases as ic
import torch_inflate_plain as inflate_plain
import torch_pee_stress as stress
from codec_tcc_tpu_torch.io.codecs import get as get_codec
from codec_tcc_tpu_torch.ops import deflate_rle as dfl
from codec_tcc_tpu_torch.ops import inflate as inf
from codec_tcc_tpu_torch.ops import raster_kernels as rk

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the raster kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("h,w,dtype", [(64, 64, np.uint16), (37, 53, np.uint8),
                                       (512, 512, np.uint16)])
def test_kernels_match_plain_on_gpu(cuda, h, w, dtype):
    rng = np.random.default_rng(h * w)
    n = h * w
    hi = 1 << (8 * np.dtype(dtype).itemsize)
    img = torch.from_numpy(rng.integers(0, hi, (h, w)).astype(dtype)).to(cuda)
    msg = torch.from_numpy(rng.integers(0, 2, 3 * n).astype(np.uint8)).to(cuda)
    starts = rng.integers(0, n, 8)
    lens = rng.integers(0, n + 1, 8)
    offs = rng.integers(0, 2 * n, 8)
    emit = n % 8 == 0
    for s in (1, 3, 8):
        st_k, mp_k = rk.raster_embed(img, msg, starts, lens, offs, s,
                                     emit_maps=emit)
        st_p, mp_p = rk.raster_embed_plain(img, msg, starts, lens, offs, s,
                                           emit_maps=emit)
        torch.cuda.synchronize()
        assert torch.equal(st_k.cpu().to(torch.int32), st_p.cpu().to(torch.int32))
        if emit:
            assert torch.equal(mp_k.cpu(), mp_p.cpu())
        ex_k = rk.raster_extract(st_k, starts, lens, offs, s, 3 * n)
        ex_p = rk.raster_extract_plain(st_k, starts, lens, offs, s, 3 * n)
        torch.cuda.synchronize()
        assert torch.equal(ex_k.cpu(), ex_p.cpu())


@pytest.mark.parametrize("h,w,dtype", [(64, 64, np.uint8), (64, 64, np.uint16),
                                       (40, 41, np.uint8), (40, 41, np.uint16),
                                       (61, 67, np.uint16),
                                       (500, 501, np.uint8)])
@pytest.mark.parametrize("shift", [0, 1])
def test_k1_plans_match_plain_on_gpu(cuda, h, w, dtype, shift):
    """K1 on the plans of ``tests/torch_raster_cases.py::k1_plans`` (window
    starts, ends and message offsets at every residue mod 16, wraps
    mid-chunk, the message ending mid-chunk, sixteen planes at s = 12),
    with maps where H*W % 8 == 0 (N/8 odd at 40x41), the image and the
    message at an aligned (shift 0) and an odd element address (shift 1)."""
    import torch_raster_cases as rc

    n = h * w
    rng = np.random.default_rng(n + shift)
    hi = 1 << (8 * np.dtype(dtype).itemsize)
    buf = torch.from_numpy(rng.integers(0, hi, n + shift).astype(dtype))
    img = buf.to(cuda)[shift:].view(h, w)
    emit = n % 8 == 0
    for _, s, starts, lens, offs, msg_len in rc.k1_plans(n, seed=n):
        msg = torch.from_numpy(rng.integers(0, 2, msg_len + shift)
                               .astype(np.uint8)).to(cuda)[shift:]
        got = rk.raster_embed(img, msg, starts, lens, offs, s, emit_maps=emit)
        ref = rk.raster_embed_plain(img, msg, starts, lens, offs, s,
                                    emit_maps=emit)
        torch.cuda.synchronize()
        assert torch.equal(got[0], ref[0])
        if emit:
            assert torch.equal(got[1], ref[1])


@pytest.mark.parametrize("h,w", [(64, 64), (40, 41)])
def test_k1_u8_maps_zero_past_eight_planes_on_gpu(cuda, h, w):
    """On uint8 the maps come from the stego narrowed to uint8, as in the
    plain version and the JAX package's ``embed`` +
    ``xor_maps_packed_batch``: with sixteen planes at s = 12, map rows 8-11
    are zero. K1 as first written built them from the un-narrowed pixel
    and wrote the message bits of planes 8-11 there."""
    import torch_raster_cases as rc

    n = h * w
    rng = np.random.default_rng(12)
    img = torch.from_numpy(rng.integers(0, 256, (h, w)).astype(np.uint8))
    _, s, starts, lens, offs, msg_len = rc.sixteen_plane_plan(n)
    msg = torch.from_numpy(rng.integers(0, 2, msg_len).astype(np.uint8))
    stego, maps = rk.raster_embed(img.to(cuda), msg.to(cuda), starts, lens,
                                  offs, s, emit_maps=True)
    want_stego, want_maps = rk.raster_embed_plain(img, msg, starts, lens,
                                                  offs, s, emit_maps=True)
    assert maps.shape == (12, n // 8)
    assert torch.equal(maps.cpu(), want_maps)
    assert torch.equal(stego.cpu(), want_stego)
    assert maps[:8].any() and not maps[8:].any()


def test_k1_five_planes_2048_repeats_on_gpu(cuda):
    """A capacity-sized plan at 2048x2048 uint16 with maps: equal to the
    plain version, and 20 repeats give identical outputs."""
    import torch_raster_cases as rc

    rng = np.random.default_rng(7)
    img = torch.from_numpy(
        rng.integers(0, 4096, (2048, 2048)).astype(np.uint16)).to(cuda)
    _, s, starts, lens, offs, msg_len = rc.five_plane_plan(img.numel(), 5)
    msg = torch.from_numpy(
        rng.integers(0, 2, msg_len).astype(np.uint8)).to(cuda)
    first = rk.raster_embed(img, msg, starts, lens, offs, s, emit_maps=True)
    ref = rk.raster_embed_plain(img, msg, starts, lens, offs, s,
                                emit_maps=True)
    assert all(torch.equal(a, b) for a, b in zip(first, ref))
    for _ in range(20):
        again = rk.raster_embed(img, msg, starts, lens, offs, s,
                                emit_maps=True)
        assert all(torch.equal(a, b) for a, b in zip(again, first))


@pytest.mark.parametrize("h,w,dtype", [(64, 64, np.uint16), (37, 53, np.uint8),
                                       (61, 67, np.uint16),
                                       (500, 501, np.uint8)])
@pytest.mark.parametrize("shift", [0, 1])
def test_k2_boundary_plans_match_plain_on_gpu(cuda, h, w, dtype, shift):
    """K2 on the plans of ``tests/torch_raster_cases.py`` (segment ends at
    every residue mod 16, wraps mid-chunk, odd starts, ``out_len`` 1, 15,
    16, 17 and past every window), the stego at an aligned (shift 0) and an
    odd element address (shift 1)."""
    import torch_raster_cases as rc

    n = h * w
    rng = np.random.default_rng(n + shift)
    hi = 1 << (8 * np.dtype(dtype).itemsize)
    buf = torch.from_numpy(rng.integers(0, hi, n + shift).astype(dtype))
    stego = buf.to(cuda)[shift:].view(h, w)
    for _, s, starts, lens, offs, out_len in rc.boundary_plans(n, seed=n):
        got = rk.raster_extract(stego, starts, lens, offs, s, out_len)
        ref = rk.raster_extract_plain(stego, starts, lens, offs, s, out_len)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), ref.cpu())


def test_k2_five_planes_2048_repeats_on_gpu(cuda):
    """A capacity-sized plan at 2048x2048 uint16: equal to the plain
    version, and 20 repeats give identical bits."""
    import torch_raster_cases as rc

    rng = np.random.default_rng(5)
    stego = torch.from_numpy(
        rng.integers(0, 4096, (2048, 2048)).astype(np.uint16)).to(cuda)
    _, s, starts, lens, offs, out_len = rc.five_plane_plan(stego.numel(), 5)
    first = rk.raster_extract(stego, starts, lens, offs, s, out_len)
    ref = rk.raster_extract_plain(stego, starts, lens, offs, s, out_len)
    assert torch.equal(first, ref)
    for _ in range(20):
        assert torch.equal(
            rk.raster_extract(stego, starts, lens, offs, s, out_len), first)


def test_gpu_encode_equals_cpu_encode(cuda):
    rng = np.random.default_rng(1)
    img = np.clip(rng.normal(2000, 300, (96, 80)), 0, 4095).astype(np.uint16)
    profiling.get_profiler().reset()
    res_g = port.encode_array(img, "gpu", bits_stored=12, device=cuda)
    res_c = port.encode_array(img, "gpu", bits_stored=12, device="cpu")
    assert res_g.container == res_c.container
    dec = port.decode_container(res_g.container, device=cuda)
    assert dec.message == "gpu"
    np.testing.assert_array_equal(dec.original, img)
    assert profiling.launches(rk.KERNELS)["raster_embed"] == 1
    assert profiling.launches(rk.KERNELS)["raster_extract"] == 1


def _pee_batch(rng, b, h, w, dtype):
    """Smooth carriers plus small noise: a realistic mix of expandable,
    shifted and (at the dtype's ceiling and floor) overflow pixels."""
    hi = (1 << (8 * np.dtype(dtype).itemsize)) - 1
    y, x = np.mgrid[0:h, 0:w]
    base = (x + 2 * y) / (w + 2 * h) * hi
    imgs = np.clip(base[None] + rng.normal(0, 2.0, (b, h, w)), 0, hi)
    imgs = imgs.astype(dtype)
    imgs[:, h // 3, :] = hi           # a row at the ceiling
    imgs[:, :, w // 4] = 0            # a column at the floor
    return imgs


@pytest.mark.parametrize("h,w,dtype", [(64, 64, np.uint16), (37, 53, np.uint8),
                                       (500, 501, np.uint8),
                                       (512, 512, np.uint16)])
@pytest.mark.parametrize("t", [1, 2, 47])
def test_pee_kernels_match_plain_on_gpu(cuda, h, w, dtype, t):
    from codec_tcc_tpu_torch.ops import pee_kernels as pk

    rng = np.random.default_rng(h + w + t)
    b = 3
    max_val = (1 << (8 * np.dtype(dtype).itemsize)) - 1
    imgs = torch.from_numpy(_pee_batch(rng, b, h, w, dtype)).to(cuda)
    msg = torch.from_numpy(
        rng.integers(0, 2, (b, h * w // 2)).astype(np.uint8)).to(cuda)
    for parity in (0, 1):
        cap = pk.pee_embed_plain(
            imgs, msg, torch.zeros(b, dtype=torch.int32, device=cuda),
            torch.zeros(b, dtype=torch.int32, device=cuda), parity, t,
            max_val)[4].cpu()
        want = torch.tensor([0, int(cap[1]) // 2, int(cap[2]) + 7],
                            dtype=torch.int32, device=cuda)
        for w_ in (want, torch.full((b,), 1 << 30, dtype=torch.int32,
                                    device=cuda)):
            base = torch.tensor([0, 5, 11], dtype=torch.int32, device=cuda)
            got = pk.pee_embed(imgs, msg, base, w_, parity, t, max_val)
            ref = pk.pee_embed_plain(imgs, msg, base, w_, parity, t, max_val)
            torch.cuda.synchronize()
            for g, r in zip(got, ref):
                assert torch.equal(g.cpu().to(torch.int32),
                                   r.cpu().to(torch.int32))
            stego, over, _, nproc, _ = got
            for out_len in (8, h * w):
                got = pk.pee_extract(stego, over, nproc, parity, t, out_len)
                ref = pk.pee_extract_plain(stego, over, nproc, parity, t,
                                           out_len)
                torch.cuda.synchronize()
                for g, r in zip(got, ref):
                    assert torch.equal(g.cpu().to(torch.int32),
                                       r.cpu().to(torch.int32))
            restored = got[0]
            assert torch.equal(restored.cpu().to(torch.int32),
                               imgs.cpu().to(torch.int32))


@pytest.mark.parametrize("t", [2, 47])
def test_pee_kernels_u8_max_val_4095_match_plain_on_gpu(cuda, t):
    """A uint8 image with BitsStored 12 embeds against 4095: expanded pixels
    wrap past 255 in K3 as in its plain version (and the JAX package), and
    K4 inverts what K3 wrote as its plain version does."""
    from codec_tcc_tpu_torch.ops import pee_kernels as pk

    rng = np.random.default_rng(t)
    b = 3
    imgs = 238 + _pee_batch(rng, b, 61, 67, np.uint8) // 15
    imgs = torch.from_numpy(imgs.astype(np.uint8)).to(cuda)
    msg = torch.from_numpy(
        rng.integers(0, 2, (b, 61 * 67 // 2)).astype(np.uint8)).to(cuda)
    base = torch.tensor([0, 5, 11], dtype=torch.int32, device=cuda)
    for parity in (0, 1):
        for want in ([0, 300, 900], [1 << 30] * 3):
            want = torch.tensor(want, dtype=torch.int32, device=cuda)
            got = pk.pee_embed(imgs, msg, base, want, parity, t, 4095)
            ref = pk.pee_embed_plain(imgs, msg, base, want, parity, t, 4095)
            torch.cuda.synchronize()
            for g, r in zip(got, ref):
                assert torch.equal(g.cpu().to(torch.int32),
                                   r.cpu().to(torch.int32))
            _k4_against_plain(got[0], got[1], got[3], parity, t, 4096)


def _k4_against_plain(stego, over, nproc, parity, t, out_len):
    """K4 equals its plain version on all three outputs. Returns K4's
    outputs."""
    from codec_tcc_tpu_torch.ops import pee_kernels as pk

    got = pk.pee_extract(stego, over, nproc, parity, t, out_len)
    ref = pk.pee_extract_plain(stego, over, nproc, parity, t, out_len)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert torch.equal(g.cpu().to(torch.int32), r.cpu().to(torch.int32))
    return got


def _k3_against_plain(imgs, msg, base, want, parity, t, max_val):
    """K3 equals its plain version on all five outputs, and K4, equal to
    its plain version, restores the image from K3's output. Returns K3's
    outputs."""
    from codec_tcc_tpu_torch.ops import pee_kernels as pk

    got = pk.pee_embed(imgs, msg, base, want, parity, t, max_val)
    ref = pk.pee_embed_plain(imgs, msg, base, want, parity, t, max_val)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert torch.equal(g.cpu().to(torch.int32), r.cpu().to(torch.int32))
    restored = _k4_against_plain(got[0], got[1], got[3], parity, t, 8)[0]
    assert torch.equal(restored, imgs)
    return got


@pytest.mark.parametrize("shape", [s[0] for s in stress.SHAPES])
def test_pee_embed_lookback_stress_on_gpu(cuda, shape):
    """Wants at and beside K3's tile boundaries, 0, 1, cap and cap + 1, in
    narrow, wide and unaligned batches."""
    from codec_tcc_tpu_torch.ops import kernel_library

    tile_px = kernel_library.library().pee_tile_pixels()
    spec = next(s for s in stress.SHAPES if s[0] == shape)
    imgs, msg, base = (torch.from_numpy(a).to(cuda)
                       for a in stress.inputs(spec))
    for t in stress.T_VALUES:
        for parity in (0, 1):
            for _, want in stress.wants(imgs, parity, t, spec[5], tile_px):
                _k3_against_plain(imgs, msg, base, want, parity, t, spec[5])


def test_pee_embed_many_tiles_repeats_on_gpu(cuda):
    """Far more tiles than the card holds at once: the look-back waits on
    tiles that started late; 20 repeats give identical outputs."""
    from codec_tcc_tpu_torch.ops import kernel_library
    from codec_tcc_tpu_torch.ops import pee_kernels as pk

    tile_px = kernel_library.library().pee_tile_pixels()
    spec = stress.MANY_TILES
    imgs, msg, base = (torch.from_numpy(a).to(cuda)
                       for a in stress.inputs(spec))
    want = dict(stress.wants(imgs, 0, 2, spec[5], tile_px))["cap"] // 2
    first = _k3_against_plain(imgs, msg, base, want, 0, 2, spec[5])
    for _ in range(20):
        again = pk.pee_embed(imgs, msg, base, want, 0, 2, spec[5])
        assert all(torch.equal(a, b) for a, b in zip(again, first))


@pytest.mark.parametrize("shape", [s[0] for s in stress.SHAPES])
def test_pee_extract_lookback_stress_on_gpu(cuda, shape):
    """K4 on K3's output at want cap with ``out_len`` and ``nproc`` at and
    beside its tile boundaries, and on forged stego and overflow bytes with
    ``nproc`` at set ranks that straddle them."""
    from codec_tcc_tpu_torch.ops import kernel_library

    tile_px = kernel_library.library().pee_tile_pixels()
    spec = next(s for s in stress.SHAPES if s[0] == shape)
    imgs, msg, base = (torch.from_numpy(a).to(cuda)
                       for a in stress.inputs(spec))
    b, h, w = imgs.shape
    forged = [torch.from_numpy(a).to(cuda) for a in stress.forged(spec, 2)]
    for parity in (0, 1):
        wants = stress.wants(imgs, parity, 2, spec[5], tile_px)
        stego, over, used, nproc, _ = _k3_against_plain(
            imgs, msg, base, dict(wants)["cap"], parity, 2, spec[5])
        for _, np_, out_len in stress.extract_cases(wants, used, nproc, h, w):
            _k4_against_plain(stego, over, np_, parity, 2, out_len)
        for _, np_ in stress.set_rank_nprocs(h, w, parity, tile_px):
            _k4_against_plain(*forged, torch.full((b,), np_, dtype=torch.int32,
                                                  device=cuda),
                              parity, 2, h * w // 2 + 1)


def test_pee_extract_many_tiles_repeats_on_gpu(cuda):
    """K4 over 8,192 tiles, most of which start after others have
    finished: 20 repeats give identical outputs, equal to the plain
    version's."""
    from codec_tcc_tpu_torch.ops import kernel_library
    from codec_tcc_tpu_torch.ops import pee_kernels as pk

    tile_px = kernel_library.library().pee_tile_pixels()
    spec = stress.MANY_TILES
    imgs, msg, base = (torch.from_numpy(a).to(cuda)
                       for a in stress.inputs(spec))
    want = dict(stress.wants(imgs, 0, 2, spec[5], tile_px))["cap"] // 2
    stego, over, _, nproc, _ = pk.pee_embed(imgs, msg, base, want, 0, 2,
                                            spec[5])
    out_len = imgs[0].numel() // 2 + 1
    first = _k4_against_plain(stego, over, nproc, 0, 2, out_len)
    assert torch.equal(first[0], imgs)
    for _ in range(20):
        again = pk.pee_extract(stego, over, nproc, 0, 2, out_len)
        assert all(torch.equal(a, b) for a, b in zip(again, first))


# the band launches, none on a whole-image path
NO_BAND = {"pee_count_band": 0, "pee_embed_band": 0,
           "pee_extract_count_band": 0, "pee_extract_band": 0}


def test_gpu_pee_encode_equals_cpu_encode(cuda):
    from codec_tcc_tpu_torch.ops import pee_kernels as pk

    rng = np.random.default_rng(2)
    img = _pee_batch(rng, 1, 96, 80, np.uint16)[0] >> 4
    # fits pass 0 at the first T: one attempt, so K3 launches exactly twice
    bits = rng.integers(0, 2, 600).astype(np.uint8)
    cfg = port.EncodeConfig(strategy="pee")
    profiling.get_profiler().reset()
    res_g = port.encode_array(img, bits, cfg, bits_stored=12, device=cuda)
    assert profiling.launches(pk.KERNELS) == {**NO_BAND, "pee_embed": 2, "pee_extract": 0}
    res_c = port.encode_array(img, bits, cfg, bits_stored=12, device="cpu")
    assert res_g.container == res_c.container
    dec = port.decode_container(res_g.container, device=cuda)
    np.testing.assert_array_equal(dec.payload_bits, bits)
    np.testing.assert_array_equal(dec.original, img)
    assert profiling.launches(pk.KERNELS) == {**NO_BAND, "pee_embed": 2, "pee_extract": 2}


def test_gpu_pee_batch_equals_cpu_batch(cuda):
    """Mixed thresholds: uint16 subgroups are gathered on the card, and K3
    and K4 launch exactly twice per attempt group and per decode group."""
    import torch_port_cases as cases
    from codec_tcc_tpu_torch.models.pee import max_value
    from codec_tcc_tpu_torch.ops import pee_kernels as pk
    from codec_tcc_tpu_torch.parallel import batch_pee

    imgs = np.stack([cases.image(cases.Case(
        "t", 48, 40, "uint16", 12, "text", "pee", 110 + i)) for i in range(4)])
    rng = np.random.default_rng(6)
    pays = [rng.integers(0, 2, n, dtype=np.uint8) for n in (100, 900, 400)]
    pays.append(cases.TEXT_PAYLOAD)
    cfg = port.EncodeConfig(strategy="pee")
    profiling.get_profiler().reset()
    res_g = batch_pee.encode_pee_batch(imgs, pays, cfg, bits_stored=12,
                                       device=cuda)
    t_start = batch_pee._start_thresholds(
        torch.from_numpy(imgs), [100, 900, 400, 304],
        max_value(int(imgs.max()), 16, 12), cfg.pee_threshold)
    groups = cases.pee_attempt_groups(t_start, res_g.thresholds)
    assert profiling.launches(pk.KERNELS) == {**NO_BAND, "pee_embed": 2 * groups,
                           "pee_extract": 0}
    res_c = batch_pee.encode_pee_batch(imgs, pays, cfg, bits_stored=12,
                                       device="cpu")
    assert len(set(res_g.thresholds.tolist())) > 1
    assert res_g.containers == res_c.containers
    for dec, img in zip(batch_pee.decode_pee_batch(res_g.containers,
                                                   device=cuda), imgs):
        np.testing.assert_array_equal(dec.original, img)
    assert profiling.launches(pk.KERNELS) == {
        **NO_BAND, "pee_embed": 2 * groups,
        "pee_extract": 2 * len(set(res_g.thresholds.tolist()))}


def test_gpu_block_encode_equals_cpu_encode(cuda):
    """block_adaptive on the card: the CPU's container, no kernel launched
    (its device work is torch ops), decoded on the card."""
    from codec_tcc_tpu_torch.ops import pee_kernels as pk

    rng = np.random.default_rng(3)
    img = np.clip(rng.normal(2000, 300, (96, 84)), 0, 4095).astype(np.uint16)
    cfg = port.EncodeConfig(strategy="block_adaptive", block_size=12)
    profiling.get_profiler().reset()
    res_g = port.encode_array(img, "block", cfg, bits_stored=12, device=cuda)
    res_c = port.encode_array(img, "block", cfg, bits_stored=12, device="cpu")
    assert res_g.container == res_c.container
    dec = port.decode_container(res_g.container, device=cuda)
    assert dec.message == "block"
    np.testing.assert_array_equal(dec.original, img)
    assert set(profiling.launches(rk.KERNELS + pk.KERNELS).values()) == {0}


@pytest.mark.parametrize("h,w,block,dtype", [(64, 64, 8, np.uint16),
                                             (61, 67, 12, np.uint16),
                                             (500, 501, 8, np.uint8)])
def test_gpu_block_extract_equals_host_extract(cuda, h, w, block, dtype):
    """The device block extract on the card equals ``extract_block_host``
    on a real embed, and on an aliased plan with a past-s plane."""
    from codec_tcc_tpu_torch.ops import blocks as block_ops
    from codec_tcc_tpu_torch.ops import embed as embed_ops
    from codec_tcc_tpu_torch.ops import host_extract
    from codec_tcc_tpu_torch.ops import segments as segment_ops

    rng = np.random.default_rng(h * w)
    n = h * w
    img = rng.integers(0, 1 << (8 * np.dtype(dtype).itemsize), (h, w))
    img = img.astype(dtype)
    s, nbits = 4, 4
    counts = host_extract.block_counts_host(img, s, block)
    base = np.zeros((nbits, counts[0].size), np.int32)
    rankings = []
    for p in range(s):
        base[p], ranking = block_ops.block_base_offsets(counts[p], h, w, block)
        rankings.append(ranking)
    total = segment_ops.usable_capacity_bits(s, n, 42)
    pp = segment_ops.raster_plane_plan(
        segment_ops.distribute_segments(s, total, 42), n, nbits, 0, True)
    msg = rng.integers(0, 2, total).astype(np.uint8)
    stego = embed_ops.embed_block_adaptive(
        torch.from_numpy(img).to(cuda), torch.from_numpy(msg).to(cuda), base,
        pp.lengths, pp.offsets, s, nbits, block)
    stego_np = stego.cpu().numpy()
    plans = [(pp.lengths, pp.offsets, total),
             (np.array([n, 300, 40, 77]), np.array([0, 0, 9, 0]), 1000)]
    for lens, offs, out_len in plans:
        got = embed_ops.extract_block_message_device(
            stego, base, lens, offs, s - 1, nbits, block, out_len)
        want = host_extract.extract_block_host(
            stego_np, rankings, lens, offs, s - 1, block, out_len)
        np.testing.assert_array_equal(got.cpu().numpy(), want)
    got = embed_ops.extract_block_message_device(
        stego, base, pp.lengths, pp.offsets, s, nbits, block, total)
    np.testing.assert_array_equal(got.cpu().numpy(), msg)


def test_gpu_block_decode_2048_equals_host_twin(cuda):
    """A 2048x2048 u16 container of 3 Mbit, encoded by ``encode_array`` on
    the card, decodes there through the base table: the payload and the
    original of the host twin (``extract_block_host`` over
    ``ranking_from_counts`` of the restored original), and one
    ``block.decode_device`` per decode."""
    from codec_tcc_tpu_torch import pipeline
    from codec_tcc_tpu_torch.io import container as container_io
    from codec_tcc_tpu_torch.ops import blocks as block_ops
    from codec_tcc_tpu_torch.ops import host_extract

    rng = np.random.default_rng(2048)
    h = w = 2048
    img = np.clip(rng.normal(2000, 300, (h, w)), 0, 4095).astype(np.uint16)
    bits = rng.integers(0, 2, 3_000_000).astype(np.uint8)
    cfg = port.EncodeConfig(strategy="block_adaptive")
    res = port.encode_array(img, bits, cfg, bits_stored=12, device=cuda)
    profiling.get_profiler().reset()
    decs = [port.decode_container(res.container, device=cuda)
            for _ in range(2)]
    assert profiling.counters().get("block.decode_device") == 2
    s, block = res.meta.s, cfg.block_size
    _, lengths, offsets = pipeline._plane_plan_from_meta(
        res.meta, h * w, pipeline._plane_bucket(s, 16))
    cont = container_io.parse(res.container)
    original = res.stego ^ cont.diff(res.stego.dtype)
    counts = host_extract.block_counts_host(original, s, block)
    rankings = [block_ops.ranking_from_counts(counts[p], h, w, block)
                for p in range(s)]
    want = host_extract.extract_block_host(
        res.stego, rankings, lengths, offsets, s, block, bits.size)
    np.testing.assert_array_equal(want, bits)
    for dec in decs:
        np.testing.assert_array_equal(dec.payload_bits, want)
        np.testing.assert_array_equal(dec.original, img)
    profiling.get_profiler().reset()


def test_gpu_block_batch_decode_equals_cpu(cuda):
    """A group of block containers decodes on the card, each through the
    single-image block decode there: the bits and originals of the CPU's
    batch decode, one ``block.decode_device`` per container."""
    from codec_tcc_tpu_torch.parallel import batch

    rng = np.random.default_rng(31)
    imgs = rng.integers(0, 4096, (3, 500, 501)).astype(np.uint16)
    pays = [rng.integers(0, 2, bits).astype(np.uint8)
            for bits in (304, 20_000, 0)]
    cfg = port.EncodeConfig(strategy="block_adaptive")
    blobs = batch.encode_batch_containers(imgs, pays, cfg, bits_stored=12,
                                          device=cuda).containers
    profiling.get_profiler().reset()
    got = batch.decode_batch_containers(blobs, device=cuda)
    assert profiling.counters().get("block.decode_device") == 3
    want = batch.decode_batch_containers(blobs, device="cpu")
    for g, w, img, p in zip(got, want, imgs, pays):
        np.testing.assert_array_equal(g.payload_bits, w.payload_bits)
        np.testing.assert_array_equal(g.payload_bits, p)
        np.testing.assert_array_equal(g.original, w.original)
        np.testing.assert_array_equal(g.original, img)
    profiling.get_profiler().reset()


def test_gpu_host_route_launches_no_k1_and_matches_fixture(cuda):
    """``device_policy="host"`` with ``device="cuda"``: no K1 launch, the
    JAX package's container (the fixture's hash), and K2 once to decode."""
    import torch_port_cases as cases

    case = cases.BY_NAME["host_mr512_u16"]
    want = cases.load_parity()[case.name]
    img = cases.image(case)
    bits = cases.payload_bits(case, 0)
    profiling.get_profiler().reset()
    res = port.encode_array(img, bits, case.config(port.EncodeConfig),
                            bits_stored=case.bits_stored, device=cuda)
    assert set(profiling.launches(rk.KERNELS).values()) == {0}
    assert cases.sha256(res.container) == want["container_sha256"]
    dec = port.decode_container(res.container, device=cuda)
    np.testing.assert_array_equal(dec.payload_bits, bits)
    np.testing.assert_array_equal(dec.original, img)
    assert profiling.launches(rk.KERNELS) == {"raster_embed": 0, "raster_extract": 1,
                           "raster_embed_batch": 0, "raster_extract_batch": 0}


# ---------------------------------------------------------------------------
# the batch axis of K1 and K2
# ---------------------------------------------------------------------------


def _batch_inputs(cuda, b, h, w, dtype, plans, seed):
    import torch_raster_cases as rc

    rng = np.random.default_rng(seed)
    hi = 1 << (8 * np.dtype(dtype).itemsize)
    imgs = torch.from_numpy(
        rng.integers(0, hi, (b, h, w)).astype(dtype)).to(cuda)
    s, starts, lens, offs, out_len = rc.batch_plans(plans, b)
    msgs = torch.from_numpy(
        rng.integers(0, 2, (b, out_len)).astype(np.uint8)).to(cuda)
    return imgs, msgs, s, starts, lens, offs, out_len


@pytest.mark.parametrize("b", [1, 3, 32])
@pytest.mark.parametrize("h,w,dtype", [(64, 64, np.uint16), (40, 41, np.uint8),
                                       (40, 41, np.uint16), (37, 53, np.uint8)])
def test_batch_kernels_match_plain_on_gpu(cuda, b, h, w, dtype):
    """K1 and K2 over a batch, each image on its own plan of
    ``tests/torch_raster_cases.py::k1_plans`` (cut points 1 to 16), equal
    to their plain versions; at 40x41 and 37x53 the images start at
    addresses that are not 16-byte aligned, and at 40x41 each map row is an
    odd number of bytes."""
    import torch_raster_cases as rc

    n = h * w
    imgs, msgs, s, starts, lens, offs, out_len = _batch_inputs(
        cuda, b, h, w, dtype, rc.k1_plans(n, seed=b), seed=b * n)
    emit = n % 8 == 0
    got = rk.raster_embed_batch(imgs, msgs, starts, lens, offs, s,
                                emit_maps=emit)
    ref = rk.raster_embed_batch_plain(imgs, msgs, starts, lens, offs, s,
                                      emit_maps=emit)
    torch.cuda.synchronize()
    assert torch.equal(got[0], ref[0])
    if emit:
        assert torch.equal(got[1], ref[1])
    for length in (out_len, 17):
        bits = rk.raster_extract_batch(got[0], starts, lens, offs, s, length)
        want = rk.raster_extract_batch_plain(got[0], starts, lens, offs, s,
                                             length)
        torch.cuda.synchronize()
        assert torch.equal(bits, want)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_batch_tables_past_launch_parameters_on_gpu(cuda, dtype):
    """B = 64 images, half of them on a sixteen-plane plan of 48 K2
    segments (24 on uint8), the other half on sixteen short windows: 64
    segment tables of 788 bytes, more than the 32 KB of launch parameters
    one launch may take. Both kernels equal their plain versions."""
    import torch_raster_cases as rc

    h, w = 30, 40
    plans = [rc.many_segment_plan(h * w), rc.sixteen_plane_plan(h * w)]
    imgs, msgs, s, starts, lens, offs, out_len = _batch_inputs(
        cuda, 64, h, w, dtype, plans, seed=64)
    bits_px = 8 * np.dtype(dtype).itemsize
    for p in range(0, 64, 2):
        _, _, plane = rk.extract_segments(
            starts[p], lens[p], offs[p], int(s[p]), h * w, out_len, bits_px)
        assert plane.size == 3 * min(16, bits_px)
    got = rk.raster_embed_batch(imgs, msgs, starts, lens, offs, s,
                                emit_maps=True)
    ref = rk.raster_embed_batch_plain(imgs, msgs, starts, lens, offs, s,
                                      emit_maps=True)
    torch.cuda.synchronize()
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    bits = rk.raster_extract_batch(got[0], starts, lens, offs, s, out_len)
    want = rk.raster_extract_batch_plain(got[0], starts, lens, offs, s,
                                         out_len)
    torch.cuda.synchronize()
    assert torch.equal(bits, want)


@pytest.mark.parametrize("h,w,dtype", [(512, 512, np.uint16),
                                       (40, 41, np.uint8)])
def test_batch_of_one_equals_single_wrappers_on_gpu(cuda, h, w, dtype):
    """B = 1 of the batch kernels gives what the single-image wrappers
    give."""
    import torch_raster_cases as rc

    n = h * w
    for plan in rc.k1_plans(n, seed=3)[::5]:
        imgs, msgs, s, starts, lens, offs, out_len = _batch_inputs(
            cuda, 1, h, w, dtype, [plan], seed=len(plan[0]))
        emit = n % 8 == 0
        batch = rk.raster_embed_batch(imgs, msgs, starts, lens, offs, s,
                                      emit_maps=emit)
        single = rk.raster_embed(imgs[0], msgs[0], starts[0], lens[0],
                                 offs[0], int(s[0]), emit_maps=emit)
        torch.cuda.synchronize()
        assert torch.equal(batch[0][0], single[0])
        if emit:
            assert torch.equal(batch[1][0], single[1])
        bits = rk.raster_extract_batch(batch[0], starts, lens, offs, s,
                                       out_len)
        one = rk.raster_extract(single[0], starts[0], lens[0], offs[0],
                                int(s[0]), out_len)
        torch.cuda.synchronize()
        assert torch.equal(bits[0], one)


@pytest.mark.parametrize("strategy", ["hybrid", "multi_plane",
                                      "block_adaptive", "pee"])
def test_gpu_batch_containers_equal_cpu_batch(cuda, strategy):
    """``encode_batch_containers`` on the card writes the CPU path's
    containers, a raster batch with exactly one K1 launch;
    ``extract_batch`` reads the payloads back with one K2 launch; the
    batch decode gives the payloads and originals back."""
    from codec_tcc_tpu_torch.parallel import batch as tb
    from codec_tcc_tpu_torch.utils.bits import bits_to_bytes

    rng = np.random.default_rng(5)
    imgs = rng.integers(0, 4096, (4, 96, 80)).astype(np.uint16)
    pays = ["batch %d" % i * (i + 1) for i in range(4)]
    cfg = port.EncodeConfig(strategy=strategy)
    cpu = tb.encode_batch_containers(imgs, pays, cfg, bits_stored=12,
                                     device="cpu")
    profiling.get_profiler().reset()
    gpu = tb.encode_batch_containers(imgs, pays, cfg, bits_stored=12,
                                     device=cuda)
    raster = strategy in ("hybrid", "multi_plane")
    assert profiling.launches(rk.KERNELS)["raster_embed_batch"] == int(raster)
    assert profiling.launches(rk.KERNELS)["raster_embed"] == 0
    assert gpu.containers == cpu.containers
    if raster:
        profiling.get_profiler().reset()
        bits = tb.extract_batch(gpu.stego, gpu.plan, device=cuda)
        assert profiling.launches(rk.KERNELS)["raster_extract_batch"] == 1
        for i, p in enumerate(pays):
            n_i = int(gpu.plan.payload_bits[i])
            assert bits_to_bytes(bits[i, :n_i]) == p.encode()
    decs = tb.decode_batch_containers(gpu.containers, device=cuda)
    for d, p, img in zip(decs, pays, imgs):
        assert d.message == p
        np.testing.assert_array_equal(d.original, img)


@pytest.mark.parametrize("strategy,dtype", [
    ("hybrid", np.uint16), ("multi_plane", np.uint8),
    ("block_adaptive", np.uint16), ("pee", np.uint16)])
def test_gpu_volume_equals_cpu_volume(cuda, strategy, dtype):
    """A 4-slice volume through ``encode_volume`` + ``pack_volume`` on the
    card writes the CPU path's STGV file (a raster volume with one batch K1
    launch); ``extract_volume`` reads the payload back with one batch K2
    launch; ``unpack_volume`` gives the payload and the volume back (the
    raster slices on the host, no launch; PEE slices through K4)."""
    from codec_tcc_tpu_torch.ops import pee_kernels as pk
    from codec_tcc_tpu_torch.parallel import volume as pv

    rng = np.random.default_rng(6)
    hi = 4096 if dtype == np.uint16 else 256
    shape = (4, 96, 80) if dtype == np.uint16 else (4, 37, 53)
    y, x = np.mgrid[0:shape[1], 0:shape[2]]
    vol = np.clip(hi * (0.3 + 0.004 * x) + rng.normal(0, 2, shape),
                  0, hi - 1).astype(dtype)
    payload = "volume on the card " * 40
    cfg = port.EncodeConfig(strategy=strategy)
    cpu = pv.pack_volume(vol, pv.encode_volume(vol, payload, cfg,
                                               device="cpu"),
                         cfg, device="cpu")
    profiling.get_profiler().reset()
    res = pv.encode_volume(vol, payload, cfg, device=cuda)
    raster = strategy in ("hybrid", "multi_plane")
    assert profiling.launches(rk.KERNELS)["raster_embed_batch"] == int(raster)
    assert pv.pack_volume(vol, res, cfg, device=cuda) == cpu
    if raster:
        profiling.get_profiler().reset()
        bits = pv.extract_volume(res.stego, res.plan, device=cuda)
        assert profiling.launches(rk.KERNELS)["raster_extract_batch"] == 1
        assert bytes(np.packbits(bits)) == payload.encode()
    profiling.get_profiler().reset()
    bits, _, original = pv.unpack_volume(cpu, device=cuda)
    assert profiling.launches(rk.KERNELS)["raster_extract_batch"] == 0
    assert (profiling.launches(pk.KERNELS)["pee_extract"] > 0) == (strategy == "pee")
    assert bytes(np.packbits(bits)) == payload.encode()
    np.testing.assert_array_equal(original, vol)


def _shard_carrier(rng, h, w, dtype, max_val):
    yy, xx = np.mgrid[0:h, 0:w]
    img = (max_val // 3 + (yy * 7 + xx * 3) % (max_val // 3)
           + rng.integers(-30, 31, (h, w)))
    return img.clip(0, max_val).astype(dtype)


# (h, w, dtype, max_val): the first four since the band mode's first port,
# then bands of one row (k = 7 over 6 rows), an odd width past one tile per
# row, and uint8 at max_val 4095 (BitsStored 12: pixels wrap past 255)
@pytest.mark.parametrize("h,w,dtype,max_val", [
    (64, 48, np.uint8, 255), (37, 53, np.uint16, 4095),
    (257, 130, np.uint16, 4095), (300, 4096, np.uint8, 255),
    (6, 37, np.uint16, 4095), (9, 4099, np.uint16, 4095),
    (64, 48, np.uint8, 4095)])
@pytest.mark.parametrize("k", [2, 3, 7])
def test_pee_shard_mode_matches_plain_on_gpu(cuda, h, w, dtype, max_val, k):
    """K3/K4's band launches (counts, apply) against their plain versions,
    band by band, exact (tile counts, stego, overflow, nproc; tile counts,
    restored, the valid bits, nbits), at wants of 0, 1, half the capacity
    (the boundary inside a band), the capacity and past it (saturated),
    both parities; the bands stitched together equal the whole-image
    K3/K4."""
    import torch_tile_cases as tiles
    from codec_tcc_tpu_torch.ops import pee_kernels as pk

    rng = np.random.default_rng(h * k)
    img = torch.from_numpy(_shard_carrier(rng, h, w, dtype, max_val))[None]
    img = img.to(cuda)
    msg = torch.from_numpy(rng.integers(0, 2, (1, 1 << 17),
                                        dtype=np.uint8)).to(cuda)
    z = torch.zeros(1, dtype=torch.int32, device=cuda)
    profiling.get_profiler().reset()
    for parity in (0, 1):
        cap = int(pk.pee_embed_plain(img, msg, z, z, parity, 3, max_val)[4])
        for want in (0, 1, cap // 2, cap, cap + 5):
            got, (stego, over, used, nproc) = tiles.embed(
                img, msg, 3, want, parity, 3, max_val, k)
            ref, _ = tiles.embed(img, msg, 3, want, parity, 3, max_val, k,
                                 plain=True)
            for g, r in zip(got, ref):
                for x, y in zip(g, r):
                    assert torch.equal(x.cpu(), y.cpu())
            whole = pk.pee_embed(img, msg, z + 3, z + want, parity, 3,
                                 max_val)
            assert torch.equal(stego.cpu(), whole[0].cpu())
            assert torch.equal(over.cpu(), whole[1].cpu())
            assert (used, nproc) == (int(whole[2][0]), int(whole[3][0]))

            out_len = max(8, 1 << max(used - 1, 0).bit_length())
            got, (restored, bits, n_bits) = tiles.extract(
                stego, over, nproc, parity, 3, out_len, k)
            ref, _ = tiles.extract(stego, over, nproc, parity, 3, out_len, k,
                                   plain=True)
            for g, r in zip(got, ref):
                for x, y in zip(g, r):
                    assert torch.equal(x.cpu(), y.cpu())
            w_r, w_bits, w_n = pk.pee_extract(
                stego, over, z + nproc, parity, 3, out_len)
            assert torch.equal(restored.cpu(), w_r.cpu())
            assert torch.equal(bits, w_bits[0].cpu())
            assert n_bits == int(w_n[0])
            # a uint8 pixel that wraps past 255 does not come back, and may
            # read as one more expanded pixel
            if max_val <= np.iinfo(dtype).max:
                assert torch.equal(restored.cpu(), img.cpu())
                assert n_bits == used
    runs = 2 * 5 * len(tiles.bands(h, k))
    # tiles.extract runs K4's count once more per band to compare it
    assert profiling.launches(pk.KERNELS) == {"pee_embed": 10, "pee_extract": 10,
                           "pee_count_band": runs, "pee_embed_band": runs,
                           "pee_extract_count_band": 2 * runs,
                           "pee_extract_band": runs}


@pytest.mark.parametrize("h,w,k", [(5, 64, 8), (6, 37, 7), (300, 256, 4)])
def test_gpu_tiled_pee_passes_equal_cpu_with_empty_bands(cuda, h, w, k):
    """``embed_pass_tiled``/``extract_pass_tiled`` on ``cuda:0`` repeated K
    times against the same passes on K CPU devices (the plain versions):
    more bands than rows (empty last bands), one-row bands and full
    bands, saturated and with the boundary inside a band."""
    from codec_tcc_tpu_torch.ops import pee as pee_ops
    from codec_tcc_tpu_torch.parallel import make_mesh, tile_pee

    rng = np.random.default_rng(h + k)
    img = _shard_carrier(rng, h, w, np.uint16, 4095)
    msg = rng.integers(0, 2, 1 << 15, dtype=np.uint8)
    meshes = [make_mesh(devices=[d] * k, axes=("tile",))
              for d in (cuda, "cpu")]
    cap = int(pee_ops.capacity(torch.from_numpy(img), 1, 3, 4095))
    for want in (cap // 2, cap + 3):
        outs = [tile_pee.embed_pass_tiled(img, msg, 5, want, 1, 3, 4095, m)
                for m in meshes]
        (s_g, o_g, u_g, n_g), (s_c, o_c, u_c, n_c) = outs
        assert (u_g, n_g) == (u_c, n_c) and u_g == min(want, cap)
        for a, b in zip(s_g + o_g, s_c + o_c):
            assert torch.equal(a.cpu(), b)
        out_len = 1 << max(3, (u_g - 1).bit_length())
        r_g, b_g, m_g = tile_pee.extract_pass_tiled(s_g, o_g, n_g, 1, 3,
                                                    out_len, meshes[0])
        r_c, b_c, m_c = tile_pee.extract_pass_tiled(s_c, o_c, n_c, 1, 3,
                                                    out_len, meshes[1])
        assert m_g == m_c == u_g
        np.testing.assert_array_equal(b_g, b_c)
        np.testing.assert_array_equal(b_g[:u_g], msg[5:5 + u_g])
        for a, b in zip(r_g, r_c):
            assert torch.equal(a.cpu(), b)
        assert np.array_equal(np.concatenate([r.cpu().numpy() for r in r_g]),
                              img)


def test_gpu_tiled_pee_runs_the_band_kernels_only(cuda, monkeypatch):
    """On the card the tiled PEE path makes no ``band_eligible_count``
    call and runs no plain band version, and its band launches copy
    nothing from the host: the profiler sees the count and apply kernels
    of both passes and no host-to-device copy."""
    from torch.profiler import ProfilerActivity, profile

    from codec_tcc_tpu_torch.ops import pee as pee_ops
    from codec_tcc_tpu_torch.ops import pee_kernels as pk
    from codec_tcc_tpu_torch.parallel import make_mesh, tile, tile_pee

    def refused(*args, **kwargs):
        raise AssertionError("a plain version on the card's band path")
    for name in ("pee_count_band_plain", "pee_embed_band_plain",
                 "pee_extract_count_band_plain", "pee_extract_band_plain"):
        monkeypatch.setattr(pk, name, refused)
    monkeypatch.setattr(pee_ops, "band_eligible_count", refused)
    img = _shard_carrier(np.random.default_rng(3), 300, 256, np.uint16, 4095)
    bits = np.random.default_rng(4).integers(0, 2, 9_000, dtype=np.uint8)
    mesh = make_mesh(devices=[cuda] * 4, axes=("tile",))
    cfg = port.EncodeConfig(strategy="pee")
    res = tile_pee.encode_array_tiled_pee(img, bits, cfg, mesh)
    assert res.container == port.encode_array(img, bits, cfg,
                                              device=cuda).container
    # one pass on bands and a message already on the card
    bands = tile.split_rows(img, mesh, "tile")
    msgs = tile._on_devices(np.pad(bits, (0, (1 << 14) - bits.size))[None],
                            bands)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, _, used, _ = tile_pee.embed_pass_tiled(bands, msgs, 0, 9_000, 0, 2,
                                                  4095, mesh)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()]
    assert used > 0
    assert sum("pee_count_band_kernel" in n for n in names) == 4
    assert sum("pee_embed_band_kernel" in n for n in names) == 4
    assert not [n for n in names if "HtoD" in n], names
    dec = tile_pee.decode_container_tiled_pee(res.container, mesh)
    np.testing.assert_array_equal(dec.payload_bits, bits)


@pytest.mark.parametrize("k", [1, 2, 4])
def test_gpu_tiled_pee_equals_single_device(cuda, k):
    """``encode_array_tiled_pee`` on ``cuda:0`` repeated K times: the
    single-device container (on the card and on the CPU), K3's band count
    and apply launches once per band per pass, K4's once per band per
    inverse pass, and an exact decode."""
    from codec_tcc_tpu_torch.io.container import parse_pee_ext
    from codec_tcc_tpu_torch.ops import pee_kernels as pk
    from codec_tcc_tpu_torch.parallel import make_mesh, tile_pee

    rng = np.random.default_rng(k)
    yy, xx = np.mgrid[0:300, 0:256]
    img = (500 + 200 * np.sin(yy / 23.0) * np.cos(xx / 31.0)
           + rng.integers(-1, 2, (300, 256))).clip(0, 900).astype(np.uint16)
    bits = rng.integers(0, 2, 12_000, dtype=np.uint8)
    cfg = port.EncodeConfig(strategy="pee")
    mesh = make_mesh(devices=[cuda] * k, axes=("tile",))
    profiling.get_profiler().reset()
    res = tile_pee.encode_array_tiled_pee(img, bits, cfg, mesh)
    embeds = profiling.launches(pk.KERNELS)["pee_embed_band"]
    assert profiling.launches(pk.KERNELS)["pee_embed"] == 0
    assert profiling.launches(pk.KERNELS)["pee_count_band"] == embeds
    single = port.encode_array(img, bits, cfg, device=cuda)
    assert res.container == single.container == port.encode_array(
        img, bits, cfg, device="cpu").container
    passes = parse_pee_ext(res.meta.ext)[1]
    assert embeds % k == 0 and embeds >= k * passes
    profiling.get_profiler().reset()
    dec = tile_pee.decode_container_tiled_pee(res.container, mesh)
    assert profiling.launches(pk.KERNELS) == {**NO_BAND, "pee_embed": 0, "pee_extract": 0,
                           "pee_extract_count_band": k * passes,
                           "pee_extract_band": k * passes}
    np.testing.assert_array_equal(dec.payload_bits, bits)
    np.testing.assert_array_equal(dec.original, img)


@pytest.mark.parametrize("strategy", ["hybrid", "block_adaptive"])
def test_gpu_tiled_raster_equals_single_device(cuda, strategy):
    """``encode_array_tiled`` over 4 bands on the card: the CPU
    single-device container, decoded exactly, with no kernel launched."""
    from codec_tcc_tpu_torch.parallel import make_mesh, tile

    img = np.random.default_rng(5).integers(0, 4096, (509, 512)).astype(
        np.uint16)
    payload = np.random.default_rng(6).bytes(20_000)
    cfg = port.EncodeConfig(strategy=strategy)
    mesh = make_mesh(devices=[cuda] * 4, axes=("tile",))
    profiling.get_profiler().reset()
    res = tile.encode_array_tiled(img, payload, cfg, mesh, bits_stored=12)
    assert res.container == port.encode_array(
        img, payload, cfg, bits_stored=12, device="cpu").container
    dec = tile.decode_container_tiled(res.container, mesh)
    assert set(profiling.launches(rk.KERNELS).values()) == {0}
    assert dec.payload == payload
    np.testing.assert_array_equal(dec.original, img)


# ---------------------------------------------------------------------------
# the dp axis: a batch split over a mesh of the card repeated
# ---------------------------------------------------------------------------


def _dp_batch(b=8, h=96, w=128):
    rng = np.random.default_rng(31)
    y, x = np.mgrid[0:h, 0:w]
    imgs = ((x * 37 + y * 11)[None] + rng.integers(0, 512, (b, h, w))) % 4096
    pays = [rng.integers(0, 2, 200 + 97 * i, dtype=np.uint8)
            for i in range(b)]
    return imgs.astype(np.uint16), pays


@pytest.mark.parametrize("strategy", ["hybrid", "block_adaptive"])
def test_gpu_dp_batch_equals_unsharded(cuda, strategy):
    """``encode_batch_containers`` over ``make_mesh(devices=["cuda:0"] *
    4)``: the unsharded containers (on the card and on the CPU), batch K1
    launched once per shard for the raster strategy and never for the
    block batch; ``extract_batch`` launches batch K2 once per shard and
    gives the payloads back."""
    from codec_tcc_tpu_torch.parallel import batch, make_mesh

    imgs, pays = _dp_batch()
    cfg = port.EncodeConfig(strategy=strategy)
    mesh = make_mesh(devices=["cuda:0"] * 4, axes=("dp",))
    profiling.get_profiler().reset()
    res = batch.encode_batch_containers(imgs, pays, cfg, mesh,
                                        bits_stored=12)
    launched = dict(profiling.launches(rk.KERNELS))
    want = batch.encode_batch_containers(imgs, pays, cfg, bits_stored=12)
    assert res.containers == want.containers == batch.encode_batch_containers(
        imgs, pays, cfg, bits_stored=12, device="cpu").containers
    raster = strategy == "hybrid"
    assert launched == {**{k: 0 for k in launched},
                        "raster_embed_batch": 4 if raster else 0}
    if raster:
        profiling.get_profiler().reset()
        bits = batch.extract_batch(res.stego, res.plan, mesh)
        assert profiling.launches(rk.KERNELS)["raster_extract_batch"] == 4
        for i, p in enumerate(pays):
            np.testing.assert_array_equal(bits[i, :p.size], p)
    decs = batch.decode_batch_containers(res.containers, mesh)
    for dec, p, img in zip(decs, pays, imgs):
        np.testing.assert_array_equal(dec.payload_bits, p)
        np.testing.assert_array_equal(dec.original, img)


def test_gpu_dp_pee_batch_and_volume_equal_unsharded(cuda):
    """The PEE batch over a (2, 2) ``("dp", "tile")`` mesh of the card:
    the unsharded containers, K3 twice per non-empty shard of each
    attempt group; a raster volume over ``dp`` = 4: the unsharded STGV,
    one batch K1 per shard, ``extract_volume`` one batch K2 per shard."""
    import torch_port_cases as cases
    from codec_tcc_tpu_torch.models.pee import max_value
    from codec_tcc_tpu_torch.ops import pee_kernels as pk
    from codec_tcc_tpu_torch.parallel import batch_pee, make_mesh, volume

    two = np.stack([cases.image(cases.Case("t", 96, 128, "uint16", 12,
                                           "text", "pee", 60 + i))
                    for i in range(2)])
    imgs = two[[0, 0, 0, 1, 1, 1, 1, 1]]
    rng = np.random.default_rng(4)
    pays = [rng.integers(0, 2, 3000, dtype=np.uint8) for _ in range(8)]
    cfg = port.EncodeConfig(strategy="pee")
    mesh = make_mesh(devices=["cuda:0"] * 4, axes=("dp", "tile"),
                     shape=(2, 2))
    profiling.get_profiler().reset()
    res = batch_pee.encode_pee_batch(imgs, pays, cfg, mesh, bits_stored=12)
    embeds = profiling.launches(pk.KERNELS)["pee_embed"]
    want = batch_pee.encode_pee_batch(imgs, pays, cfg, bits_stored=12,
                                      device="cpu")
    assert res.containers == want.containers
    t_start = batch_pee._start_thresholds(
        torch.from_numpy(imgs), [p.size for p in pays],
        max_value(int(imgs.max()), 16, 12), cfg.pee_threshold)
    groups = cases.pee_attempt_group_lists(t_start, res.thresholds)
    shards = cases.pee_group_shards(groups, 2, mesh.size)
    assert embeds == 2 * sum(len(sizes) for sizes in shards)

    vol = np.random.default_rng(8).integers(0, 4096, (8, 128, 96)).astype(
        np.uint16)
    dp4 = make_mesh(devices=["cuda:0"] * 4, axes=("dp",))
    vcfg = port.EncodeConfig(strategy="hybrid")
    profiling.get_profiler().reset()
    vres = volume.encode_volume(vol, "a dp volume", vcfg, dp4)
    assert profiling.launches(rk.KERNELS)["raster_embed_batch"] == 4
    blob = volume.pack_volume(vol, vres, vcfg)
    cpu = volume.encode_volume(vol, "a dp volume", vcfg, device="cpu")
    assert blob == volume.pack_volume(vol, cpu, vcfg, device="cpu")
    profiling.get_profiler().reset()
    bits = volume.extract_volume(vres.stego, vres.plan, dp4)
    assert profiling.launches(rk.KERNELS)["raster_extract_batch"] == 4
    assert bytes(np.packbits(bits)) == b"a dp volume"


# ---------------------------------------------------------------------------
# the other transport codecs, STGC v1 and the serving daemon
# ---------------------------------------------------------------------------


@pytest.fixture
def native(cuda):
    from torch_native import build_native_once

    build_native_once()
    return cuda


@pytest.mark.parametrize("name", ["jls_mr512_u16", "jls_ot512_u8",
                                  "jls_pee_mr512_u16_text",
                                  "jls_blk_mr512_u16", "jls_v1_mr512_u16"])
def test_gpu_jls_containers_match_fixture(native, name):
    """``codec="jls"`` (and v1) through the card's kernels: the JAX
    package's container (the fixture's ``codecs`` section), exact decode."""
    import torch_port_cases as cases

    case = {c.name: c for c in cases.CODEC_CASES}[name]
    want = cases.load_parity_codecs()[name]
    img = cases.image(case)
    bits = cases.payload_bits(case, 0)
    res = port.encode_array(img, bits, case.config(port.EncodeConfig),
                            bits_stored=case.bits_stored, device=native)
    assert cases.sha256(res.container) == want["container_sha256"]
    dec = port.decode_container(res.container, device=native)
    np.testing.assert_array_equal(dec.payload_bits, bits)
    assert dec.original.dtype == img.dtype
    np.testing.assert_array_equal(dec.original, img)


def test_gpu_jls_volume_matches_fixture(native):
    import torch_port_cases as cases
    from codec_tcc_tpu_torch.parallel import volume as pv

    vcase = cases.CODEC_VOLUME
    want = cases.load_parity_codecs()[vcase.name]
    vol = cases.volume(vcase)
    bits = cases.volume_payload_bits(vcase, want["lsb_bits"])
    cfg = vcase.config(port.EncodeConfig)
    res = pv.encode_volume(vol, bits, cfg, device=native)
    blob = pv.pack_volume(vol, res, cfg, device=native)
    assert cases.sha256(blob) == want["stgv_sha256"]
    payload, _, original = pv.unpack_volume(blob, device=native)
    np.testing.assert_array_equal(payload, bits)
    np.testing.assert_array_equal(original, vol)


def test_gpu_serve_daemon_matches_fixture(native, tmp_path):
    """The daemon in a thread on the card: ``ping`` says cuda, and its
    ``encode`` of a DICOM file writes the JAX package's ``encode_file``
    container (the fixture's ``serve`` section)."""
    import os
    import tempfile
    import threading
    import time

    import torch_port_cases as cases
    from codec_tcc_tpu_torch import serve
    from codec_tcc_tpu_torch.io import dicom

    work = tempfile.mkdtemp(prefix="ct_")
    sock = os.path.join(work, "g.sock")
    rc = []
    thread = threading.Thread(target=lambda: rc.append(serve.serve(
        sock, idle_timeout=120, device=native)), daemon=True)
    thread.start()
    deadline = time.monotonic() + 120
    while not os.path.exists(sock) and time.monotonic() < deadline:
        time.sleep(0.05)
    try:
        ping = serve.request(sock, {"op": "ping"})
        assert ping["backend"] == "cuda"
        assert ping["device_count"] == torch.cuda.device_count()
        for name, base, overrides in cases.SERVE_ENCODES:
            path = str(tmp_path / f"{name}.dcm")
            dicom.save_image(cases.image(cases.BY_NAME[base]), path,
                             bits_stored=12)
            out = str(tmp_path / f"{name}.stgc")
            r = serve.request(sock, {
                "op": "encode", "input": path, "output": out,
                "message": cases.TEXT_PAYLOAD,
                "config": cases.serve_config(base, overrides)})
            assert r["ok"], r
            with open(out, "rb") as f:
                assert (cases.sha256(f.read())
                        == cases.load_parity_serve()[name]["container_sha256"])
            d = serve.request(sock, {"op": "decode", "input": out})
            assert d["ok"] and d["payload_b64"]
    finally:
        serve.request(sock, {"op": "shutdown"})
        thread.join(timeout=60)
    assert rc == [0]


def test_gpu_copy_bytes_are_the_shapes_bytes(cuda):
    """One 512x512 u16 encode + decode on the card: the copy counters and
    each stage's span hold exactly the bytes its shapes give. Up: the
    image, the message bits, the deflate stream for the inflate kernels
    (padded to whole words and two more). Down: the int64 value
    histogram, the int32 plane-0 tile popcounts of the hybrid scan, the
    stego, the packed maps of planes 0..s-1, the twelve float32 moments,
    the deflate kernels' length and stream, the inflate kernels' 16-byte
    status and the inflated stego, and K2's bit row."""
    rng = np.random.default_rng(17)
    img = np.clip(rng.normal(2000, 300, (512, 512)), 0, 4095).astype(np.uint16)
    bits = rng.integers(0, 2, 304).astype(np.uint8)
    n = img.size
    dfl.check_device_route(cuda)   # the probe's copies come before
    prof = profiling.get_profiler()
    prof.reset()
    profiling.enable()
    try:
        res = port.encode_array(img, bits, bits_stored=12, device=cuda)
        dec = port.decode_container(res.container, device=cuda)
    finally:
        profiling.disable()
    np.testing.assert_array_equal(dec.payload_bits, bits)
    stream = len(port.io.container.parse(res.container).stego_blob) - 13
    block = port.EncodeConfig().search_block_size
    expected = {
        "image_upload": (img.nbytes, 0),
        "decompose": (0, 65536 * 8),
        "block_scan": (0, (512 // block) * (512 // block) * 4),
        "embed": (bits.size, img.nbytes + res.s * n // 8 + 12 * 4),
        "transport_codec": (0, 8 + len(get_codec("deflate").encode(
            res.stego))),
        "transport_decode": (4 * ((stream + 3) // 4 + 2), 16 + img.nbytes),
        "extract": (0, bits.size),
    }
    report = prof.report()
    for name, row in report.items():
        assert (row["h2d_bytes"], row["d2h_bytes"]) == expected.get(
            name, (0, 0)), name
    counters = profiling.counters()
    assert counters["h2d_bytes"] == sum(up for up, _ in expected.values())
    assert counters["d2h_bytes"] == sum(down for _, down in expected.values())
    for span in prof.spans:
        assert (span.h2d_bytes, span.d2h_bytes) == expected.get(
            span.name, (0, 0)), span.name
    prof.reset()


# ---------------------------------------------------------------------------
# the deflate kernels (csrc/deflate_rle.cu)
# ---------------------------------------------------------------------------


def _deflate_images(name):
    if name == "probe":
        return dfl.probe_images()
    if name == "frame_4096x3328":
        return [dc.phantom(4096, 3328, seed=5)]
    if name.startswith("phantom_") and name not in dc.NAMES:
        h, w = (int(v) for v in name[len("phantom_"):].split("x"))
        return [dc.phantom(h, w)]
    return [dc.case(name)]


@pytest.mark.parametrize("name", [*dc.NAMES, "probe", "phantom_512x512",
                                  "phantom_2048x2048", "frame_4096x3328"])
def test_deflate_kernels_give_zlibs_bytes_on_gpu(cuda, name):
    """The kernels' stream equals host zlib's (the deflate codec's encode)
    byte for byte on the corpus of tests/torch_deflate_cases.py, the
    probe, the benchmark's phantoms and a 4096x3328 frame."""
    codec = get_codec("deflate")
    for image in _deflate_images(name):
        got = dfl.encode_device(torch.from_numpy(image).to(cuda))
        torch.cuda.synchronize()
        assert got == codec.encode(image), name


def test_deflate_kernels_repeat_on_gpu(cuda):
    """20 encodes of one 2048x2048 phantom give the same bytes: the tiles'
    look-backs and the atomic writes leave no trace of their order."""
    image = dc.phantom(2048, 2048, seed=3)
    t = torch.from_numpy(image).to(cuda)
    outs = {dfl.encode_device(t) for _ in range(20)}
    assert outs == {get_codec("deflate").encode(image)}


def _counts_since(before):
    after = profiling.counters()
    return {k: after.get(k, 0) - before.get(k, 0)
            for k in ["codec.deflate_device", "codec.deflate_host",
                      *("launch." + k for k in dfl.KERNELS)]}


@pytest.mark.parametrize("strategy", ["hybrid", "pee", "block_adaptive"])
def test_gpu_encode_deflates_the_stego_on_the_card(cuda, strategy):
    """A single-image encode on the card compresses its stego with one
    launch of each deflate kernel and gives the CPU path's container."""
    dfl.check_device_route(cuda)
    rng = np.random.default_rng(23)
    img = np.clip(rng.normal(2000, 300, (96, 80)), 0, 4095).astype(np.uint16)
    cfg = port.EncodeConfig(strategy=strategy)
    before = profiling.counters()
    res_g = port.encode_array(img, "gpu", cfg, bits_stored=12, device=cuda)
    counts = _counts_since(before)
    assert counts == {"codec.deflate_device": 1, "codec.deflate_host": 0,
                      **{"launch." + k: 1 for k in dfl.KERNELS}}
    res_c = port.encode_array(img, "gpu", cfg, bits_stored=12, device="cpu")
    assert res_g.container == res_c.container


def test_gpu_probe_mismatch_raises(cuda, monkeypatch):
    """Where the host compressor gives other bytes than the kernels on the
    probe (a test double stands in for it), the encode of a stego on the
    card raises, naming the process's zlib, and launches nothing more."""
    import zlib

    monkeypatch.setattr(dfl, "_host_encode", lambda image: b"not zlib's")
    dfl._route_ok.cache_clear()
    rng = np.random.default_rng(29)
    img = np.clip(rng.normal(2000, 300, (96, 80)), 0, 4095).astype(np.uint16)
    try:
        with pytest.raises(RuntimeError, match=zlib.ZLIB_RUNTIME_VERSION):
            dfl.check_device_route(cuda)
        before = profiling.counters()
        with pytest.raises(RuntimeError, match="deflate kernels"):
            port.encode_array(img, "gpu", bits_stored=12, device=cuda)
        counts = _counts_since(before)
    finally:
        dfl._route_ok.cache_clear()
    assert counts == {"codec.deflate_device": 0, "codec.deflate_host": 0,
                      **{"launch." + k: 0 for k in dfl.KERNELS}}


def test_gpu_deflate_stream_over_the_limit_raises(cuda, monkeypatch):
    """A stream longer than the kernels take raises rather than leaving the
    card: the limit stands in at 100 bytes here."""
    monkeypatch.setattr(dfl, "max_stream_bytes", lambda: 100)
    t = torch.zeros((8, 7), dtype=torch.uint16, device=cuda)
    with pytest.raises(ValueError, match="exceeds"):
        dfl.encode_device(t)
    assert len(dfl.encode_device(t[:, :6].contiguous())) > 13


# ---------------------------------------------------------------------------
# the inflate kernels (csrc/inflate.cu)
# ---------------------------------------------------------------------------


def _inflate_payload(name):
    if name.startswith("phantom_"):
        shape, seed = name[len("phantom_"):].split("_seed")
        h, w = (int(v) for v in shape.split("x"))
        return ic.phantom_payload(h, w, int(seed))
    return ic.payload(name)


def _inflate_cap(blob):
    code, h, w = inf.sdfl_fields(blob)
    return inf.limits(len(blob) - inf.SDFL_HEADER,
                      h * w * (2 if code == 3 else 1))[0]


def _plain_counts(blob):
    plain = inflate_plain.inflate_plain(blob, _inflate_cap(blob))
    return plain.status, (plain.candidates, plain.blocks, plain.serial)


@pytest.mark.parametrize("name", [
    *ic.DEVICE, *(f"phantom_{h}x{w}_seed{seed}" for h, w in ic.PHANTOM_SHAPES
                  for seed in ic.PHANTOM_SEEDS)])
def test_inflate_kernels_give_zlibs_bytes_on_gpu(cuda, name):
    """The kernels' image equals host zlib's (the deflate codec's decode):
    the corpus, uint8, stored blocks only, one block, fixed-code blocks
    (decoded by the chain itself: serial blocks), more blocks than the
    emit's grid (the chain emits the rest), more candidates than the
    measure takes (the chain decodes the blocks of those left out), and
    the benchmark's phantoms at 512x512 and 2048x2048 on three seeds (no
    serial block); one launch of each kernel a call, and the plain
    version's counts (past the cap, the scan keeps candidates in no fixed
    order, so fewer blocks may be serial than the plain version's)."""
    blob = _inflate_payload(name)
    before = profiling.launches(inf.KERNELS)
    res = inf.inflate_device(blob, cuda)
    after = profiling.launches(inf.KERNELS)
    assert {k: after[k] - before[k] for k in inf.KERNELS} == \
        {k: 1 for k in inf.KERNELS}
    assert res.status == inf.OK, inf.STATUS.get(res.status)
    assert np.array_equal(res.stego.cpu().numpy(),
                          get_codec("deflate").decode(blob))
    if name.startswith("phantom_"):
        assert res.serial == 0 and res.candidates > 0
    else:
        status, (ncand, nblocks, nserial) = _plain_counts(blob)
        assert (status, ncand, nblocks) == (inf.OK, res.candidates,
                                            res.blocks)
        if ncand <= _inflate_cap(blob):
            assert res.serial == nserial
        else:
            assert res.serial <= nserial
    if name.startswith("fixed_code"):
        assert res.serial == res.blocks > 0


def test_inflate_kernels_repeat_on_gpu(cuda):
    """10 inflates of one 2048x2048 phantom give the same image."""
    blob = ic.phantom_payload(2048, 2048, 3)
    outs = {inf.inflate_device(blob, cuda).stego.cpu().numpy().tobytes()
            for _ in range(10)}
    assert outs == {get_codec("deflate").decode(blob).tobytes()}


@pytest.mark.parametrize("name", ic.HOST)
def test_gpu_decode_leaves_foreign_streams_to_the_host(cuda, name):
    """A payload the kernels do not take, or whose status is not OK, is
    the host codec's: its image (status FOREIGN), or its ``Invalid file:``
    message word for word, counted on the host side; the kernels' status
    is the plain version's."""
    blob = ic.payload(name)
    codec = get_codec("deflate")
    try:
        want, err = codec.decode(blob), None
    except ValueError as exc:
        want, err = None, str(exc)
    if inf.device_route(codec, blob, cuda):
        res = inf.inflate_device(blob, cuda)
        assert res.status != inf.OK and res.stego is None
        assert _plain_counts(blob)[0] == res.status
    before = profiling.counters()
    if err is None:
        got, got_dev = inf.transport_decode(codec, blob, cuda)
        assert got_dev is None and np.array_equal(got, want)
    else:
        with pytest.raises(ValueError) as info:
            inf.transport_decode(codec, blob, cuda)
        assert str(info.value) == err
    after = profiling.counters()
    assert after.get("codec.inflate_host", 0) - \
        before.get("codec.inflate_host", 0) == 1
    assert after.get("codec.inflate_device", 0) == \
        before.get("codec.inflate_device", 0)


def _inflate_counts_since(before):
    after = profiling.counters()
    return {k: after.get(k, 0) - before.get(k, 0)
            for k in ["codec.inflate_device", "codec.inflate_host",
                      "inflate.serial_blocks",
                      *("launch." + k for k in inf.KERNELS)]}


@pytest.mark.parametrize("strategy", ["hybrid", "pee", "block_adaptive"])
def test_gpu_decode_inflates_the_stego_on_the_card(cuda, strategy):
    """A single-image decode on the card inflates its stego with one launch
    of each inflate kernel and gives the CPU path's payload, stego and
    original."""
    rng = np.random.default_rng(31)
    img = np.clip(rng.normal(2000, 300, (96, 80)), 0, 4095).astype(np.uint16)
    cfg = port.EncodeConfig(strategy=strategy)
    res = port.encode_array(img, "gpu", cfg, bits_stored=12, device=cuda)
    before = profiling.counters()
    dec_g = port.decode_container(res.container, device=cuda)
    counts = _inflate_counts_since(before)
    blocks = profiling.counters().get("inflate.blocks", 0) - \
        before.get("inflate.blocks", 0)
    assert counts == {"codec.inflate_device": 1, "codec.inflate_host": 0,
                      "inflate.serial_blocks": 0,
                      **{"launch." + k: 1 for k in inf.KERNELS}}
    assert blocks >= 1
    dec_c = port.decode_container(res.container, device="cpu")
    np.testing.assert_array_equal(dec_g.payload_bits, dec_c.payload_bits)
    np.testing.assert_array_equal(dec_g.stego, dec_c.stego)
    np.testing.assert_array_equal(dec_g.original, dec_c.original)
    np.testing.assert_array_equal(dec_g.original, img)


@pytest.mark.parametrize("h,w,nbits", [(512, 512, 100_000),
                                       (4096, 3328, 6_000_000)])
def test_gpu_tiled_pee_codes_the_stego_on_the_card(cuda, h, w, nbits):
    """The tiled PEE route over 4 bands of ``cuda:0`` (the 4096x3328 frame
    is ``TILED_BIG``'s parity case): one request deflates and inflates its
    stego on the card, never on the host, with no serial inflate block,
    gives ``encode_array``'s container and decodes exactly."""
    import torch_port_cases as cases
    from codec_tcc_tpu_torch.parallel import make_mesh, tile_pee

    img = cases.image(cases.Case("t", h, w, "uint16", 12, "text", "pee", 41))
    bits = np.random.default_rng(h).integers(0, 2, nbits, dtype=np.uint8)
    cfg = port.EncodeConfig(strategy="pee")
    mesh = make_mesh(devices=["cuda:0"] * 4, axes=("tile",))
    keys = ("codec.deflate_device", "codec.deflate_host",
            "codec.inflate_device", "codec.inflate_host",
            "inflate.serial_blocks")
    before = profiling.counters()
    res = tile_pee.encode_array_tiled_pee(img, bits, cfg, mesh,
                                          bits_stored=12)
    dec = tile_pee.decode_container_tiled_pee(res.container, mesh)
    after = profiling.counters()
    assert {k: after.get(k, 0) - before.get(k, 0) for k in keys} == {
        "codec.deflate_device": 1, "codec.deflate_host": 0,
        "codec.inflate_device": 1, "codec.inflate_host": 0,
        "inflate.serial_blocks": 0}
    assert res.container == port.encode_array(img, bits, cfg, bits_stored=12,
                                              device=cuda).container
    np.testing.assert_array_equal(dec.payload_bits, bits)
    np.testing.assert_array_equal(dec.original, img)


def _pee_map_decode(decode, blob):
    """Run ``decode(blob)`` with the copy counters reset: returns its result,
    the ``pee.map_*`` counts, and the host-to-device bytes in all, in
    ``transport_decode`` and in ``extract``."""
    prof = profiling.get_profiler()
    prof.reset()
    dec = decode(blob)
    counters = profiling.counters()
    report = prof.report()
    prof.reset()
    maps = {k: counters.get(k, 0) for k in ("pee.map_device", "pee.map_host")}
    return dec, maps, counters.get("h2d_bytes", 0), \
        report["transport_decode"]["h2d_bytes"], report["extract"]["h2d_bytes"]


@pytest.mark.parametrize("payload", ["text", "bits:3000000"])
def test_gpu_pee_decode_expands_the_map_on_the_card(cuda, payload):
    """A 2048x2048 PEE decode on the card (304 bits, one pass; 3 Mbit, two)
    uploads the overflow map packed, ``ceil(h*w/8)`` bytes in ``extract``
    beside the two pass boundaries, and expands it there: one
    ``pee.map_device``, no ``pee.map_host``, no ``h*w``-byte map upload, and
    the CPU decode's payload, stego and original."""
    import torch_port_cases as cases

    seed = cases.BY_NAME["pee_cr2048_u16_3m"].seed
    case = cases.Case("t", 2048, 2048, "uint16", 12, payload, "pee", seed)
    img, bits = cases.image(case), cases.payload_bits(case, 0)
    res = port.encode_array(img, bits, port.EncodeConfig(strategy="pee"),
                            bits_stored=12, device=cuda)
    n = img.size
    dec_g, maps, h2d, h2d_stream, h2d_extract = _pee_map_decode(
        lambda b: port.decode_container(b, device=cuda), res.container)
    assert maps == {"pee.map_device": 1, "pee.map_host": 0}
    assert h2d_extract == (n + 7) // 8 + 8
    assert h2d == h2d_stream + h2d_extract
    assert h2d_stream < len(res.container)
    dec_c = port.decode_container(res.container, device="cpu")
    np.testing.assert_array_equal(dec_g.payload_bits, dec_c.payload_bits)
    np.testing.assert_array_equal(dec_g.payload_bits, bits)
    np.testing.assert_array_equal(dec_g.stego, dec_c.stego)
    np.testing.assert_array_equal(dec_g.original, dec_c.original)
    np.testing.assert_array_equal(dec_g.original, img)


@pytest.mark.parametrize("nbits", [304, 200_000])
def test_gpu_tiled_pee_decode_expands_the_map_on_the_card(cuda, nbits):
    """The tiled PEE decode over four bands of ``cuda:0`` of a 1024x832
    image expands the packed map once on the first band's device and splits
    it: the same counts and ``ceil(h*w/8)`` map bytes up as the single
    decode, and the CPU decode's payload, stego and original."""
    import torch_port_cases as cases
    from codec_tcc_tpu_torch.parallel import make_mesh, tile_pee

    img = cases.image(cases.Case("t", 1024, 832, "uint16", 12, "text", "pee",
                                 43))
    bits = np.random.default_rng(nbits).integers(0, 2, nbits, dtype=np.uint8)
    cfg = port.EncodeConfig(strategy="pee")
    mesh = make_mesh(devices=["cuda:0"] * 4, axes=("tile",))
    res = tile_pee.encode_array_tiled_pee(img, bits, cfg, mesh,
                                          bits_stored=12)
    n = img.size
    dec_g, maps, h2d, h2d_stream, h2d_extract = _pee_map_decode(
        lambda b: tile_pee.decode_container_tiled_pee(b, mesh),
        res.container)
    assert maps == {"pee.map_device": 1, "pee.map_host": 0}
    assert h2d_extract == (n + 7) // 8
    assert h2d == h2d_stream + h2d_extract
    dec_c = port.decode_container(res.container, device="cpu")
    np.testing.assert_array_equal(dec_g.payload_bits, dec_c.payload_bits)
    np.testing.assert_array_equal(dec_g.payload_bits, bits)
    np.testing.assert_array_equal(dec_g.stego, dec_c.stego)
    np.testing.assert_array_equal(dec_g.original, img)


@pytest.mark.parametrize("name", ["golden_hybrid", "golden_hybrid_packed",
                                  "golden_multi_plane",
                                  "golden_block_adaptive", "golden_pee"])
def test_gpu_golden_containers_decode_as_on_the_cpu(cuda, name):
    """The golden containers (interleaved SDFL code 2, the host's) decode on
    the card as on the CPU, through host zlib; their stego deflated as the
    codec writes it now (code 3) inflates on the card to the same image."""
    import os

    from codec_tcc_tpu_torch.io import container as container_io

    path = os.path.join(os.path.dirname(__file__), "data", f"{name}.stgc")
    with open(path, "rb") as f:
        blob = f.read()
    before = profiling.counters()
    dec_g = port.decode_container(blob, device=cuda)
    counts = _inflate_counts_since(before)
    assert counts["codec.inflate_host"] == 1
    assert counts["codec.inflate_device"] == 0
    dec_c = port.decode_container(blob, device="cpu")
    np.testing.assert_array_equal(dec_g.payload_bits, dec_c.payload_bits)
    np.testing.assert_array_equal(dec_g.stego, dec_c.stego)
    if dec_c.original is not None:
        np.testing.assert_array_equal(dec_g.original, dec_c.original)
    codec = get_codec("deflate")
    stego = codec.decode(container_io.parse(blob).stego_blob)
    res = inf.inflate_device(codec.encode(stego), cuda)
    assert res.status == inf.OK
    assert np.array_equal(res.stego.cpu().numpy(), stego)
