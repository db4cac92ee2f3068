"""The port's raster tile sharding (``parallel/tile.py``) and its meshes
(``parallel/mesh.py``) against the JAX package's on a mesh of CPU devices:
containers of ``encode_array_tiled`` for ``hybrid``, ``multi_plane`` and
``block_adaptive`` equal to the JAX package's tiled and single-device
containers and to the port's single-device one, for K in 1, 2, 4, 8 and on
the 509x512 odd geometry, decoded exactly by ``decode_container_tiled``;
``histogram_tiled`` and ``pair_stats_tiled``, the volume slice-plane case,
the wrong-shape-stego error, the mesh, and ``same_code`` on the copied host
functions. Exact everywhere but the float32 moments (rel 1e-6) and ``mse``
(rel 1e-5, as ``tests/test_tile.py``)."""

import numpy as np
import pytest
import torch

import codec_tcc_tpu as jax_pkg
from codec_tcc_tpu.ops import embed as jax_embed
from codec_tcc_tpu.ops import segments as jax_segments
from codec_tcc_tpu.parallel import mesh as jax_mesh
from codec_tcc_tpu.parallel import tile as jax_tile
import codec_tcc_tpu_torch as port
from codec_tcc_tpu_torch.io import container as container_io
from codec_tcc_tpu_torch.io.codecs import get as get_codec
from codec_tcc_tpu_torch.ops import embed as port_embed
from codec_tcc_tpu_torch.ops import metrics as port_metrics
from codec_tcc_tpu_torch.ops import raster_kernels as rk
from codec_tcc_tpu_torch.ops import segments as port_segments
from codec_tcc_tpu_torch.parallel import mesh as port_mesh
from codec_tcc_tpu_torch.parallel import tile as port_tile

from torch_parity import same_code

torch.set_num_threads(1)

STRATEGIES = ["hybrid", "multi_plane", "block_adaptive"]


@pytest.fixture(scope="module")
def jax_tile_mesh():
    return jax_mesh.make_mesh(8, ("tile",))


def _cpu_mesh(k):
    return port_mesh.make_mesh(devices=["cpu"] * k, axes=("tile",))


def _image(h, w, seed, peak=4096):
    return np.random.default_rng(seed).integers(0, peak, size=(h, w)).astype(
        np.uint16)


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_tiled_containers_match_jax_and_single_device(jax_tile_mesh, strategy,
                                                      k):
    """256x192 u16, 12 BitsStored, over K CPU devices: the JAX package's
    tiled bytes and the single-device bytes of both packages; the tiled
    decode gives the payload and the original, and the report equals the
    single-device one (mse at rel 1e-5, the rest exact)."""
    img = _image(256, 192, seed=11)
    payload = np.random.default_rng(k).bytes(3_000)
    res = port_tile.encode_array_tiled(
        img, payload, port.EncodeConfig(strategy=strategy), _cpu_mesh(k),
        bits_stored=12)
    single = port.encode_array(img, payload,
                               port.EncodeConfig(strategy=strategy),
                               bits_stored=12, device="cpu")
    j_res = jax_tile.encode_array_tiled(
        img, payload, jax_pkg.EncodeConfig(strategy=strategy),
        jax_tile_mesh, bits_stored=12)
    assert res.container == single.container == j_res.container
    assert res.s == single.s
    assert res.metrics["mse"] == pytest.approx(single.metrics["mse"],
                                               rel=1e-5)
    for key in ("changed_pixels", "max_abs_diff", "mean_abs_diff"):
        assert res.metrics[key] == single.metrics[key], key
    dec = port_tile.decode_container_tiled(res.container, _cpu_mesh(k))
    assert dec.payload == payload
    np.testing.assert_array_equal(dec.original, img)


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_tiled_odd_geometry_matches_jax(jax_tile_mesh, strategy, k):
    """509x512 (prime rows; the port's last band is shorter where the JAX
    package pads it): the same bytes, decoded by both decoders."""
    img = _image(509, 512, seed=11)
    payload = np.random.default_rng(11).bytes(4_000)
    cfg = dict(strategy=strategy, beta=0.4, compute_metrics=False)
    res = port_tile.encode_array_tiled(img, payload, port.EncodeConfig(**cfg),
                                       _cpu_mesh(k))
    single = port.encode_array(img, payload, port.EncodeConfig(**cfg),
                               device="cpu")
    assert res.container == single.container
    if k == 8:
        j_res = jax_tile.encode_array_tiled(
            img, payload, jax_pkg.EncodeConfig(**cfg), jax_tile_mesh)
        assert res.container == j_res.container
    dec = port_tile.decode_container_tiled(res.container, _cpu_mesh(k))
    assert dec.payload == payload
    np.testing.assert_array_equal(dec.original, img)
    assert port.decode_container(res.container,
                                 device="cpu").payload == payload


def test_tiled_u8_and_more_bands_than_rows(jax_tile_mesh):
    """u8 over 8 bands, and 5 rows over 8 bands (three empty)."""
    img8 = np.random.default_rng(3).integers(0, 256, (40, 48)).astype(
        np.uint8)
    res = port_tile.encode_array_tiled(img8, "u8 tiled", port.EncodeConfig(),
                                       _cpu_mesh(8))
    j_res = jax_tile.encode_array_tiled(img8, "u8 tiled",
                                        jax_pkg.EncodeConfig(), jax_tile_mesh)
    assert res.container == j_res.container
    img5 = _image(5, 64, seed=4)
    for strategy in STRATEGIES:
        cfg = port.EncodeConfig(strategy=strategy)
        res5 = port_tile.encode_array_tiled(img5, b"five", cfg, _cpu_mesh(8),
                                            bits_stored=12)
        single = port.encode_array(img5, b"five", cfg, bits_stored=12,
                                   device="cpu")
        assert res5.container == single.container
        dec = port_tile.decode_container_tiled(res5.container, _cpu_mesh(8))
        assert dec.payload == b"five"
        np.testing.assert_array_equal(dec.original, img5)


def test_tiled_encode_runs_no_kernel():
    """The tiled raster bodies are torch ops on each band's device (XLA in
    the JAX package): no K1/K2 launch or call."""
    rk.reset_launch_counts()
    img = _image(64, 64, seed=2)
    res = port_tile.encode_array_tiled(img, "x", port.EncodeConfig(),
                                       _cpu_mesh(2))
    port_tile.decode_container_tiled(res.container, _cpu_mesh(2))
    assert set(rk.LAUNCHES.values()) == {0}


def test_tiled_refusals():
    img = _image(32, 32, seed=1)
    with pytest.raises(ValueError, match="requires a mesh"):
        port_tile.encode_array_tiled(img, b"x", port.EncodeConfig())
    with pytest.raises(ValueError, match="supports multi_plane"):
        port_tile.encode_array_tiled(img, b"x", port.EncodeConfig(
            strategy="pee"), _cpu_mesh(2))
    with pytest.raises(ValueError, match="exceeds the usable capacity"):
        port_tile.encode_array_tiled(img, np.ones(40_000, np.uint8),
                                     port.EncodeConfig(), _cpu_mesh(2))
    pee = port.encode_array(img, b"x", port.EncodeConfig(strategy="pee"),
                            device="cpu").container
    with pytest.raises(ValueError, match="does not support pee"):
        port_tile.decode_container_tiled(pee, _cpu_mesh(2))


def test_tiled_decode_rejects_wrong_shape_stego():
    """A stego blob of another geometry than its header raises the
    'Invalid file' error, as in the JAX package's tiled decoder."""
    rng = np.random.default_rng(9)
    img = _image(64, 64, seed=9)
    cfg = port.EncodeConfig(strategy="block_adaptive", compute_metrics=False)
    cont = container_io.parse(
        port.encode_array(img, b"x", cfg, device="cpu").container)
    wrong = rng.integers(0, 4096, size=(16, 64)).astype(np.uint16)
    bad = container_io.pack(cont.meta, cont.bitmaps_blob,
                            get_codec("deflate").encode(wrong))
    with pytest.raises(ValueError, match="Invalid file"):
        port_tile.decode_container_tiled(bad, _cpu_mesh(4))


def test_tiled_volume_slice_plane(jax_tile_mesh):
    """One slice-plane of a volume split over 8 bands: the bands' embed
    equals the single-image embed and the JAX package's tiled embed, and
    the bands' windows extract the payload."""
    rng = np.random.default_rng(11)
    slice_img = rng.integers(0, 4096, size=(4, 512, 512)).astype(
        np.uint16)[2]
    payload = rng.integers(0, 2, size=120_000).astype(np.uint8)
    plan = port_segments.distribute_segments(3, payload.size, 42)
    pp = port_segments.raster_plane_plan(plan, slice_img.size, 16, 0, True)
    tp = port_tile.shard_windows(pp, slice_img.size, 8)
    msg_pad = port_embed.pad_message(payload, tp.local_n, int(tp.moffs.max()))
    stego = port_tile.join_rows(
        port_tile.embed_tiled(slice_img, msg_pad, tp, _cpu_mesh(8)))
    ref = port_embed.embed(
        torch.from_numpy(slice_img),
        torch.from_numpy(port_embed.pad_message(payload, slice_img.size,
                                                int(pp.offsets.max()))),
        pp.starts, pp.lengths, pp.offsets, 3, 16).numpy()
    np.testing.assert_array_equal(stego, ref)
    j_tp = jax_tile.shard_windows(
        jax_segments.raster_plane_plan(
            jax_segments.distribute_segments(3, payload.size, 42),
            slice_img.size, 16, 0, True), slice_img.size, 8)
    np.testing.assert_array_equal(
        stego, np.asarray(jax_tile.embed_tiled(slice_img, msg_pad, j_tp,
                                               jax_tile_mesh)))
    aligned = port_tile.extract_tiled_aligned(stego, tp, _cpu_mesh(8))
    np.testing.assert_array_equal(
        aligned, np.asarray(jax_tile.extract_tiled_aligned(stego, j_tp,
                                                           jax_tile_mesh)))
    np.testing.assert_array_equal(
        port_tile.assemble_tiled(aligned, tp, payload.size), payload)


@pytest.mark.parametrize("h,w,k", [(101, 64, 8), (512, 512, 3), (7, 9, 8)])
def test_histogram_tiled_is_exact(jax_tile_mesh, h, w, k):
    img8 = np.random.default_rng(h).integers(0, 256, (h, w)).astype(np.uint8)
    counts = port_tile.histogram_tiled(img8, 256, _cpu_mesh(k))
    np.testing.assert_array_equal(counts,
                                  np.bincount(img8.ravel(), minlength=256))
    np.testing.assert_array_equal(
        counts, jax_tile.histogram_tiled(img8, 256, jax_tile_mesh))
    img16 = _image(h, w, seed=k, peak=65536)
    np.testing.assert_array_equal(
        port_tile.histogram_tiled(img16, 65536, _cpu_mesh(k)),
        np.bincount(img16.ravel(), minlength=65536))


def test_pair_stats_tiled_matches_whole_image_moments():
    """Per-band moments summed and maxed equal the whole image's: exact
    for the integer-valued ones, rel 1e-6 for the float32 sums."""
    a = _image(97, 80, seed=5)
    b = (a ^ np.random.default_rng(6).integers(0, 4, a.shape).astype(
        np.uint16))
    tiled = port_tile.pair_stats_tiled(a, b, _cpu_mesh(4))
    whole = port_metrics.pair_stats(torch.from_numpy(a), torch.from_numpy(b))
    assert set(tiled) == set(whole)
    for key in ("n", "max_absdiff", "changed", "max_a", "max_b",
                "sum_absdiff", "sum_sqdiff"):
        assert float(tiled[key]) == float(whole[key]), key
    for key in ("sum_a", "sum_b", "sum_a2", "sum_b2", "sum_ab"):
        assert float(tiled[key]) == pytest.approx(float(whole[key]),
                                                  rel=1e-6), key


def test_make_mesh():
    mesh = port_mesh.make_mesh(devices=["cpu"] * 8, axes=("dp", "tile"),
                               shape=(2, 4))
    assert mesh.shape == {"dp": 2, "tile": 4} and mesh.size == 8
    assert mesh.axis_devices("tile") == [torch.device("cpu")] * 4
    assert mesh.axis_names == ("dp", "tile")
    one = port_mesh.make_mesh(3, ("tile",), devices=["cpu"] * 5)
    assert one.shape == {"tile": 3}
    with pytest.raises(ValueError, match="requested 6 devices, have 5"):
        port_mesh.make_mesh(6, devices=["cpu"] * 5)
    with pytest.raises(ValueError, match="no 'tile'"):
        port_mesh.make_mesh(devices=["cpu"]).axis_devices("tile")
    if not torch.cuda.is_available():
        # the default devices are the visible cards: none here, and the
        # mesh does not fall back to the CPU
        with pytest.raises(ValueError, match="requested 1 devices, have 0"):
            port_mesh.make_mesh()


@pytest.mark.parametrize("name", ["TileParams", "shard_windows", "shard_rows",
                                  "assemble_tiled", "_host_block_geometry"])
def test_copied_host_functions_are_the_same_code(name):
    assert same_code(getattr(port_tile, name), getattr(jax_tile, name))


def test_shard_windows_cover_ring_exactly():
    """The copied window tables match the JAX package's on a wrapping plan
    split over uneven bands."""
    plan = port_segments.distribute_segments(3, 6000, 42)
    pp = port_segments.raster_plane_plan(plan, 4096, 8, 3900, False)
    j_pp = jax_segments.raster_plane_plan(
        jax_segments.distribute_segments(3, 6000, 42), 4096, 8, 3900, False)
    for k, local_n in ((8, None), (3, 22 * 64)):
        tp = port_tile.shard_windows(pp, 4096, k, local_n)
        j_tp = jax_tile.shard_windows(j_pp, 4096, k, local_n)
        for field in ("plane_id", "starts", "lens", "moffs"):
            np.testing.assert_array_equal(getattr(tp, field),
                                          getattr(j_tp, field))
