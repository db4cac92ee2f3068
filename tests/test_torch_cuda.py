"""The port's CUDA kernels on a GPU: K1-K4, the batch forms of K1/K2 and
the shard mode of K3/K4 against their plain versions; the raster, PEE,
block_adaptive, container batch and tiled (one image across a mesh of the
card repeated) encode paths against the CPU path; the device block
extract against its host twin; the host embed route with no K1. Marked ``cuda``: they skip where no GPU is present and run on the GPU
machine with

    python -m pytest tests/test_torch_cuda.py -m cuda -q

(this file imports no jax, so it runs where jax is not installed)."""

import numpy as np
import pytest
import torch

import codec_tcc_tpu_torch as port
import torch_pee_stress as stress
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
    rk.reset_launch_counts()
    res_g = port.encode_array(img, "gpu", bits_stored=12, device=cuda)
    res_c = port.encode_array(img, "gpu", bits_stored=12, device="cpu")
    assert res_g.container == res_c.container
    dec = port.decode_container(res_g.container, device=cuda)
    assert dec.message == "gpu"
    np.testing.assert_array_equal(dec.original, img)
    assert rk.LAUNCHES["raster_embed"] == 1
    assert rk.LAUNCHES["raster_extract"] == 1


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


def test_gpu_pee_encode_equals_cpu_encode(cuda):
    from codec_tcc_tpu_torch.ops import pee_kernels as pk

    rng = np.random.default_rng(2)
    img = _pee_batch(rng, 1, 96, 80, np.uint16)[0] >> 4
    # fits pass 0 at the first T: one attempt, so K3 launches exactly twice
    bits = rng.integers(0, 2, 600).astype(np.uint8)
    cfg = port.EncodeConfig(strategy="pee")
    pk.reset_launch_counts()
    res_g = port.encode_array(img, bits, cfg, bits_stored=12, device=cuda)
    assert pk.LAUNCHES == {"pee_embed": 2, "pee_extract": 0,
                           "pee_embed_shard": 0, "pee_extract_shard": 0}
    res_c = port.encode_array(img, bits, cfg, bits_stored=12, device="cpu")
    assert res_g.container == res_c.container
    dec = port.decode_container(res_g.container, device=cuda)
    np.testing.assert_array_equal(dec.payload_bits, bits)
    np.testing.assert_array_equal(dec.original, img)
    assert pk.LAUNCHES == {"pee_embed": 2, "pee_extract": 2,
                           "pee_embed_shard": 0, "pee_extract_shard": 0}


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
    pk.reset_launch_counts()
    res_g = batch_pee.encode_pee_batch(imgs, pays, cfg, bits_stored=12,
                                       device=cuda)
    t_start = batch_pee._start_thresholds(
        torch.from_numpy(imgs), [100, 900, 400, 304],
        max_value(int(imgs.max()), 16, 12), cfg.pee_threshold)
    groups = cases.pee_attempt_groups(t_start, res_g.thresholds)
    assert pk.LAUNCHES == {"pee_embed": 2 * groups, "pee_extract": 0,
                           "pee_embed_shard": 0, "pee_extract_shard": 0}
    res_c = batch_pee.encode_pee_batch(imgs, pays, cfg, bits_stored=12,
                                       device="cpu")
    assert len(set(res_g.thresholds.tolist())) > 1
    assert res_g.containers == res_c.containers
    for dec, img in zip(batch_pee.decode_pee_batch(res_g.containers,
                                                   device=cuda), imgs):
        np.testing.assert_array_equal(dec.original, img)
    assert pk.LAUNCHES == {
        "pee_embed": 2 * groups,
        "pee_extract": 2 * len(set(res_g.thresholds.tolist())),
        "pee_embed_shard": 0, "pee_extract_shard": 0}


def test_gpu_block_encode_equals_cpu_encode(cuda):
    """block_adaptive on the card: the CPU's container, no kernel launched
    (its device work is torch ops), decoded on the host."""
    from codec_tcc_tpu_torch.ops import pee_kernels as pk

    rng = np.random.default_rng(3)
    img = np.clip(rng.normal(2000, 300, (96, 84)), 0, 4095).astype(np.uint16)
    cfg = port.EncodeConfig(strategy="block_adaptive", block_size=12)
    rk.reset_launch_counts()
    pk.reset_launch_counts()
    res_g = port.encode_array(img, "block", cfg, bits_stored=12, device=cuda)
    res_c = port.encode_array(img, "block", cfg, bits_stored=12, device="cpu")
    assert res_g.container == res_c.container
    dec = port.decode_container(res_g.container, device=cuda)
    assert dec.message == "block"
    np.testing.assert_array_equal(dec.original, img)
    assert set(rk.LAUNCHES.values()) == {0} and set(pk.LAUNCHES.values()) == {0}


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


def test_gpu_host_route_launches_no_k1_and_matches_fixture(cuda):
    """``device_policy="host"`` with ``device="cuda"``: no K1 launch, the
    JAX package's container (the fixture's hash), and K2 once to decode."""
    import torch_port_cases as cases

    case = cases.BY_NAME["host_mr512_u16"]
    want = cases.load_parity()[case.name]
    img = cases.image(case)
    bits = cases.payload_bits(case, 0)
    rk.reset_launch_counts()
    res = port.encode_array(img, bits, case.config(port.EncodeConfig),
                            bits_stored=case.bits_stored, device=cuda)
    assert set(rk.LAUNCHES.values()) == {0}
    assert cases.sha256(res.container) == want["container_sha256"]
    dec = port.decode_container(res.container, device=cuda)
    np.testing.assert_array_equal(dec.payload_bits, bits)
    np.testing.assert_array_equal(dec.original, img)
    assert rk.LAUNCHES == {"raster_embed": 0, "raster_extract": 1,
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
    rk.reset_launch_counts()
    gpu = tb.encode_batch_containers(imgs, pays, cfg, bits_stored=12,
                                     device=cuda)
    raster = strategy in ("hybrid", "multi_plane")
    assert rk.LAUNCHES["raster_embed_batch"] == int(raster)
    assert rk.LAUNCHES["raster_embed"] == 0
    assert gpu.containers == cpu.containers
    if raster:
        rk.reset_launch_counts()
        bits = tb.extract_batch(gpu.stego, gpu.plan, device=cuda)
        assert rk.LAUNCHES["raster_extract_batch"] == 1
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
    rk.reset_launch_counts()
    res = pv.encode_volume(vol, payload, cfg, device=cuda)
    raster = strategy in ("hybrid", "multi_plane")
    assert rk.LAUNCHES["raster_embed_batch"] == int(raster)
    assert pv.pack_volume(vol, res, cfg, device=cuda) == cpu
    if raster:
        rk.reset_launch_counts()
        bits = pv.extract_volume(res.stego, res.plan, device=cuda)
        assert rk.LAUNCHES["raster_extract_batch"] == 1
        assert bytes(np.packbits(bits)) == payload.encode()
    rk.reset_launch_counts()
    pk.reset_launch_counts()
    bits, _, original = pv.unpack_volume(cpu, device=cuda)
    assert rk.LAUNCHES["raster_extract_batch"] == 0
    assert (pk.LAUNCHES["pee_extract"] > 0) == (strategy == "pee")
    assert bytes(np.packbits(bits)) == payload.encode()
    np.testing.assert_array_equal(original, vol)


def _shard_carrier(rng, h, w, dtype, max_val):
    yy, xx = np.mgrid[0:h, 0:w]
    img = (max_val // 3 + (yy * 7 + xx * 3) % (max_val // 3)
           + rng.integers(-30, 31, (h, w)))
    return img.clip(0, max_val).astype(dtype)


@pytest.mark.parametrize("h,w,dtype,max_val", [
    (64, 48, np.uint8, 255), (37, 53, np.uint16, 4095),
    (257, 130, np.uint16, 4095), (300, 4096, np.uint8, 255)])
@pytest.mark.parametrize("k", [2, 3, 7])
def test_pee_shard_mode_matches_plain_on_gpu(cuda, h, w, dtype, max_val, k):
    """K3/K4 in shard mode against their plain band versions, band by band,
    exact (stego, overflow, count, nproc; restored, bits, nbits), at wants
    of 0, 1, half the capacity, the capacity and past it, both parities;
    the bands stitched together equal the whole-image K3/K4."""
    import torch_tile_cases as tiles
    from codec_tcc_tpu_torch.ops import pee_kernels as pk

    rng = np.random.default_rng(h * k)
    img = torch.from_numpy(_shard_carrier(rng, h, w, dtype, max_val))[None]
    img = img.to(cuda)
    msg = torch.from_numpy(rng.integers(0, 2, (1, 1 << 17),
                                        dtype=np.uint8)).to(cuda)
    z = torch.zeros(1, dtype=torch.int32, device=cuda)
    pk.reset_launch_counts()
    for parity in (0, 1):
        cap = int(pk.pee_embed_plain(img, msg, z, z, parity, 3, max_val)[4])
        for want in (0, 1, cap // 2, cap, cap + 5):
            got, (stego, over, used, nproc) = tiles.embed(
                pk.pee_embed, img, msg, 3, want, parity, 3, max_val, k)
            ref, _ = tiles.embed(pk.pee_embed_plain, img, msg, 3, want,
                                 parity, 3, max_val, k)
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
                pk.pee_extract, stego, over, nproc, parity, 3, out_len, k)
            ref, _ = tiles.extract(pk.pee_extract_plain, stego, over, nproc,
                                   parity, 3, out_len, k)
            for g, r in zip(got, ref):
                for x, y in zip(g, r):
                    assert torch.equal(x.cpu(), y.cpu())
            w_r, w_bits, w_n = pk.pee_extract(
                stego, over, z + nproc, parity, 3, out_len)
            assert torch.equal(restored.cpu(), w_r.cpu())
            assert torch.equal(restored.cpu(), img.cpu())
            assert torch.equal(bits, w_bits[0].cpu())
            assert n_bits == int(w_n[0]) == used
    n_bands = len(tiles.bands(h, k))
    assert pk.LAUNCHES["pee_embed_shard"] == 2 * 5 * n_bands
    assert pk.LAUNCHES["pee_extract_shard"] == 2 * 5 * n_bands


@pytest.mark.parametrize("k", [1, 2, 4])
def test_gpu_tiled_pee_equals_single_device(cuda, k):
    """``encode_array_tiled_pee`` on ``cuda:0`` repeated K times: the
    single-device container (on the card and on the CPU), one K3 shard
    launch per band per pass, one K4 per band per inverse pass, and an
    exact decode."""
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
    pk.reset_launch_counts()
    res = tile_pee.encode_array_tiled_pee(img, bits, cfg, mesh)
    embeds = pk.LAUNCHES["pee_embed_shard"]
    assert pk.LAUNCHES["pee_embed"] == 0
    single = port.encode_array(img, bits, cfg, device=cuda)
    assert res.container == single.container == port.encode_array(
        img, bits, cfg, device="cpu").container
    passes = parse_pee_ext(res.meta.ext)[1]
    assert embeds % k == 0 and embeds >= k * passes
    pk.reset_launch_counts()
    dec = tile_pee.decode_container_tiled_pee(res.container, mesh)
    assert pk.LAUNCHES["pee_extract_shard"] == k * passes
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
    rk.reset_launch_counts()
    res = tile.encode_array_tiled(img, payload, cfg, mesh, bits_stored=12)
    assert res.container == port.encode_array(
        img, payload, cfg, bits_stored=12, device="cpu").container
    dec = tile.decode_container_tiled(res.container, mesh)
    assert set(rk.LAUNCHES.values()) == {0}
    assert dec.payload == payload
    np.testing.assert_array_equal(dec.original, img)
