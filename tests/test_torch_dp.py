"""The ``dp`` axis of the port (``parallel/mesh.py::dp_shards``: a batch
split over a mesh's ``dp`` devices) against the JAX package on the CPU.

The JAX package runs on its 8-device virtual CPU mesh; the port on meshes
of CPU devices (``make_mesh(devices=["cpu"] * k)``): ``("dp",)`` of 2, 4
and 8 and ``("dp", "tile")`` of shape (4, 2). On the same seeded inputs:
the containers of ``encode_batch_containers`` for every strategy, on
uint16, uint8 and an odd geometry, with and without metrics; the stego of
``encode_batch`` and the bits of ``extract_batch``; ``volume_cut_point``,
the STGV bytes of a raster and a PEE volume and ``extract_volume``; a
ragged mixed batch through ``decode_batch_containers``; the
``ValueError`` of a batch that does not split evenly; the F1 batch; and
the kernel wrappers called once per non-empty shard, with the shard's
rows. Everything is exact but the float32 quality moments, which use the
tolerances of ``tests/test_torch_batch.py`` and
``tests/test_torch_volume.py``.
"""

import numpy as np
import pytest
import torch

from codec_tcc_tpu.config import EncodeConfig as JaxConfig
from codec_tcc_tpu.parallel import batch as jb
from codec_tcc_tpu.parallel import batch_pee as jbp
from codec_tcc_tpu.parallel import mesh as jax_mesh
from codec_tcc_tpu.parallel import volume as jv
from codec_tcc_tpu_torch.config import EncodeConfig
from codec_tcc_tpu_torch.models import pee as port_model
from codec_tcc_tpu_torch.ops import pee_kernels as pk
from codec_tcc_tpu_torch.ops import raster_kernels as rk
from codec_tcc_tpu_torch.parallel import batch as tb
from codec_tcc_tpu_torch.parallel import batch_pee as tbp
from codec_tcc_tpu_torch.parallel import volume as tv
from codec_tcc_tpu_torch.parallel.mesh import (
    dp_devices, dp_shards, lead_device, make_mesh,
)
from codec_tcc_tpu_torch.pipeline import _as_payload_bits

import torch_port_cases as cases

torch.set_num_threads(1)

B = 8
MESHES = {"dp2": ((2,), ("dp",)), "dp4": ((4,), ("dp",)),
          "dp8": ((8,), ("dp",)), "dp4x2": ((4, 2), ("dp", "tile"))}
# name -> (h, w, dtype, bits_stored); "odd" has H*W % 8 != 0 (raw maps)
GEOMS = {"u16": (24, 32, np.uint16, 12), "u8": (16, 24, np.uint8, None),
         "odd": (25, 31, np.uint16, 12)}
STRATEGIES = ("hybrid", "multi_plane", "block_adaptive", "pee")

# the tolerances of tests/test_torch_batch.py (float32 moments summed in
# another order than XLA's)
REPORT_RTOL = 1e-6
SSIM_ATOL = 5e-5
METRIC_RTOL = 1e-4     # the volume report's, tests/test_torch_volume.py


def _mesh(name):
    shape, axes = MESHES[name]
    return make_mesh(devices=["cpu"] * int(np.prod(shape)), axes=axes,
                     shape=shape)


@pytest.fixture(scope="module")
def jmesh():
    return jax_mesh.make_mesh(8, ("dp",))


def _raster_images(seed, b, h, w, dtype):
    rng = np.random.default_rng(seed)
    hi = 4096 if dtype == np.uint16 else 256
    y, x = np.mgrid[0:h, 0:w]
    base = (x * 37 + y * 11) % hi
    return ((base[None] + rng.integers(0, hi // 8, (b, h, w))) % hi
            ).astype(dtype)


def _pee_images(seed, b, h, w, dtype, bits_stored):
    """The parity phantoms: random images have too little PEE capacity."""
    return np.stack([
        cases.image(cases.Case("t", h, w, np.dtype(dtype).name,
                               bits_stored or 8, "text", "pee", seed + i))
        for i in range(b)])


def _images(strategy, geom, seed=3, b=B):
    h, w, dtype, bits_stored = GEOMS[geom]
    if strategy == "pee":
        return _pee_images(seed, b, h, w, dtype, bits_stored)
    return _raster_images(seed, b, h, w, dtype)


def _payloads(seed, b, strategy):
    """Mixed payload kinds and sizes: under PEE they give the images
    different thresholds, so the attempt groups have uneven sizes."""
    rng = np.random.default_rng(seed)
    sizes = ((30, 90, 160, 240, 60, 200, 120, 10) if strategy == "pee"
             else (41, 54, 67, 80, 93, 106, 119, 132))
    out = []
    for i in range(b):
        if i % 3 == 0:
            out.append("dp %d" % i)
        elif i % 3 == 1:
            out.append(bytes(rng.integers(0, 256, sizes[i] // 8,
                                          dtype=np.uint8)))
        else:
            out.append(rng.integers(0, 2, sizes[i]).astype(np.uint8))
    return out


def _assert_reports_match(got, want, equal_range: bool):
    """``equal_range``: the stego's maximum is the image's. Where it is
    not (PEE expands past it), the range normalisation takes ``mse``,
    ``psnr`` and ``ssim`` from differences of float32 moments that cancel
    in both packages, so only the moments that do not cancel are compared
    there, as in ``tests/test_torch_volume.py``."""
    assert got.keys() == want.keys()
    for k in ("changed_pixels", "max_abs_diff", "max_value"):
        assert got[k] == want[k], k
    for k in ("mean_abs_diff", "changed_percent"):
        np.testing.assert_allclose(got[k], want[k], rtol=REPORT_RTOL,
                                   err_msg=k)
    if equal_range:
        for k in ("mse", "psnr"):
            np.testing.assert_allclose(got[k], want[k], rtol=REPORT_RTOL,
                                       err_msg=k)
        assert abs(got["ssim"] - want["ssim"]) <= SSIM_ATOL


class _Calls:
    """Counts the calls of a kernel wrapper and the batch size and device
    of each (the plain versions run on the CPU, so the launch counters do
    not move)."""

    def __init__(self, monkeypatch, module, name):
        self.sizes, self.devices = [], []
        fn = getattr(module, name)

        def counted(images, *args, **kwargs):
            self.sizes.append(int(images.shape[0]))
            self.devices.append(images.device)
            return fn(images, *args, **kwargs)
        monkeypatch.setattr(module, name, counted)


# ---------------------------------------------------------------------------
# the split
# ---------------------------------------------------------------------------


def test_dp_shards_split_as_the_jax_sharding():
    cpu = torch.device("cpu")
    mesh = _mesh("dp4x2")
    assert len(dp_devices(mesh)) == 4 and mesh.size == 8
    assert dp_shards(8, mesh) == [(cpu, slice(2 * i, 2 * i + 2))
                                  for i in range(4)]
    assert dp_shards(3, None, "cpu") == [(cpu, slice(0, 3))]
    with pytest.raises(ValueError, match="batch of 6 .* dp axis of 4"):
        dp_shards(6, mesh)
    assert dp_shards(6, mesh, uneven="single") == [(cpu, slice(0, 6))]
    # a group of 3 split as its padding to 4 would be: the last shard empty
    assert dp_shards(3, mesh, rows=4) == [
        (cpu, slice(0, 1)), (cpu, slice(1, 2)), (cpu, slice(2, 3)),
        (cpu, slice(3, 3))]
    assert dp_shards(3, _mesh("dp2"), rows=4) == [(cpu, slice(0, 2)),
                                                  (cpu, slice(2, 3))]
    tile_only = make_mesh(devices=["cpu"] * 4, axes=("tile",))
    assert dp_shards(5, tile_only) == [(cpu, slice(0, 5))]
    assert lead_device(mesh) == cpu and lead_device(None, "cpu") == cpu
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            dp_shards(2, make_mesh(devices=["cuda:0"] * 2))


# ---------------------------------------------------------------------------
# the container batch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("metrics", [False, True], ids=["plain", "metrics"])
@pytest.mark.parametrize("geom", list(GEOMS))
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_batch_containers_match_jax_under_dp(jmesh, strategy, geom, metrics):
    imgs = _images(strategy, geom)
    pays = _payloads(11, B, strategy)
    bits_stored = GEOMS[geom][3]
    cfg = dict(strategy=strategy, compute_metrics=metrics)
    want = jb.encode_batch_containers(imgs, pays, JaxConfig(**cfg), jmesh,
                                      bits_stored=bits_stored)
    for name in (None, *MESHES):
        got = tb.encode_batch_containers(
            imgs, pays, EncodeConfig(**cfg),
            None if name is None else _mesh(name),
            bits_stored=bits_stored, device="cpu")
        assert got.containers == want.containers, name
        np.testing.assert_array_equal(got.stego, np.asarray(want.stego))
        if metrics:
            for g, w, img, st in zip(got.metrics, want.metrics, imgs,
                                     got.stego):
                _assert_reports_match(g, w, int(img.max()) == int(st.max()))
        else:
            assert got.metrics is None and want.metrics is None


@pytest.mark.parametrize("name", list(MESHES))
def test_raster_batch_launches_once_per_shard(monkeypatch, name):
    """The device route of the container batch calls batch K1 once per
    ``dp`` shard with the shard's rows; ``extract_batch`` calls batch K2
    once per shard; the block batch launches no kernel."""
    mesh = _mesh(name)
    dp = len(dp_devices(mesh))
    imgs = _images("hybrid", "u16")
    pays = _payloads(11, B, "hybrid")
    k1 = _Calls(monkeypatch, rk, "raster_embed_batch")
    k2 = _Calls(monkeypatch, rk, "raster_extract_batch")
    res = tb.encode_batch_containers(imgs, pays, EncodeConfig(), mesh,
                                     bits_stored=12, device="cpu")
    assert k1.sizes == [B // dp] * dp and k2.sizes == []
    tb.extract_batch(res.stego, res.plan, mesh, device="cpu")
    assert k2.sizes == [B // dp] * dp
    tb.encode_batch_containers(imgs, pays,
                               EncodeConfig(strategy="block_adaptive"), mesh,
                               bits_stored=12, device="cpu")
    assert len(k1.sizes) == dp


def test_auto_route_keeps_the_device_for_a_mesh(monkeypatch):
    """``auto`` without metrics takes the host route on one device and the
    device route on a mesh of more than one (the JAX package routes with
    ``mesh.size``); a one-device mesh stays on the host."""
    imgs = _images("hybrid", "u16")
    pays = _payloads(11, B, "hybrid")
    cfg = EncodeConfig(compute_metrics=False)
    k1 = _Calls(monkeypatch, rk, "raster_embed_batch")
    want = tb.encode_batch_containers(imgs, pays, cfg, bits_stored=12,
                                      device="cpu")
    one = tb.encode_batch_containers(
        imgs, pays, cfg, make_mesh(devices=["cpu"]), bits_stored=12,
        device="cpu")
    assert k1.sizes == []
    got = tb.encode_batch_containers(imgs, pays, cfg, _mesh("dp4"),
                                     bits_stored=12, device="cpu")
    assert k1.sizes == [2] * 4
    assert got.containers == one.containers == want.containers


@pytest.mark.parametrize("name", ["dp2", "dp8", "dp4x2"])
def test_encode_and_extract_batch_match_jax_under_dp(jmesh, monkeypatch,
                                                     name):
    imgs = _images("multi_plane", "odd")
    pays = _payloads(12, B, "multi_plane")
    plan = jb.plan_batch(imgs, pays, JaxConfig(strategy="multi_plane"))
    want_stego = np.asarray(jb.encode_batch(imgs, plan, jmesh))
    want_bits = jb.extract_batch(want_stego, plan, jmesh)
    want_al = np.asarray(jb.extract_aligned_batch(want_stego, plan, jmesh))
    mesh = _mesh(name)
    dp = len(dp_devices(mesh))
    k1 = _Calls(monkeypatch, rk, "raster_embed_batch")
    k2 = _Calls(monkeypatch, rk, "raster_extract_batch")
    stego = tb.encode_batch(imgs, plan, mesh, device="cpu")
    np.testing.assert_array_equal(stego.numpy(), want_stego)
    np.testing.assert_array_equal(
        tb.extract_batch(stego, plan, mesh, device="cpu"), want_bits)
    np.testing.assert_array_equal(
        tb.extract_aligned_batch(stego, plan, mesh, device="cpu").numpy(),
        want_al)
    assert k1.sizes == [B // dp] * dp and k2.sizes == [B // dp] * 2 * dp


# ---------------------------------------------------------------------------
# PEE: the histograms per shard, the attempt groups split by the JAX rule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(MESHES))
def test_pee_groups_split_over_dp(jmesh, monkeypatch, name):
    """Each equal-T attempt group splits over ``dp`` when its power-of-two
    size is a multiple of the mesh's size (the last shards shorter or
    empty, never padded) and runs on the first ``dp`` device otherwise:
    ``embed_both_passes`` is called once per non-empty shard with the
    shard's rows, and the containers are the JAX package's."""
    # two phantoms, three and five times, with payloads of one size: equal-T
    # groups of 3 and 8, then escalation groups of 11, 11 and 6 entries that
    # hold images twice (padded sizes 4, 8, 16 and 8)
    two = _images("pee", "u16", b=2)
    imgs = two[[0, 0, 0, 1, 1, 1, 1, 1]]
    rng = np.random.default_rng(4)
    pays = [rng.integers(0, 2, 150, dtype=np.uint8) for _ in range(B)]
    cfg = dict(strategy="pee")
    want = jbp.encode_pee_batch(imgs, pays, JaxConfig(**cfg), jmesh,
                                bits_stored=12)
    mesh = _mesh(name)
    calls = _Calls(monkeypatch, pk, "embed_both_passes")
    got = tbp.encode_pee_batch(imgs, pays, EncodeConfig(**cfg), mesh,
                               bits_stored=12, device="cpu")
    assert got.containers == want.containers
    t_start = tbp._start_thresholds(
        torch.from_numpy(imgs), [_as_payload_bits(p).size for p in pays],
        port_model.max_value(int(imgs.max()), 16, 12),
        EncodeConfig(**cfg).pee_threshold)
    groups = cases.pee_attempt_group_lists(t_start, got.thresholds)
    shards = cases.pee_group_shards(groups, len(dp_devices(mesh)), mesh.size)
    assert calls.sizes == [n for group in shards for n in group]
    assert [len(idxs) for _, idxs in groups] == [3, 8, 11, 11, 6]
    assert any(len(sizes) > 1 for sizes in shards)


@pytest.mark.parametrize("dp", [2, 3])
def test_f1_batch_over_dp(monkeypatch, dp):
    """F1's batch of three (its escalation group ``[2, 0, 2]`` holds an
    image twice): over ``dp`` = 3 the histograms run per shard and the
    group, whose padded size 4 is no multiple of 3, runs on the first
    device, gathered from the three shards; the containers are the JAX
    package's on a 3-device mesh. Over ``dp`` = 2 the batch of three does
    not split: both packages raise ``ValueError``."""
    imgs, pays = cases.f1_batch()
    cfg = dict(strategy="pee", pee_threshold=cases.F1_THRESHOLD)
    mesh = make_mesh(devices=["cpu"] * dp)
    jm = jax_mesh.make_mesh(dp, ("dp",))
    if dp == 2:
        with pytest.raises(ValueError):
            jbp.encode_pee_batch(imgs, pays, JaxConfig(**cfg), jm)
        with pytest.raises(ValueError, match="batch of 3"):
            tbp.encode_pee_batch(imgs, pays, EncodeConfig(**cfg), mesh,
                                 device="cpu")
        return
    want = jbp.encode_pee_batch(imgs, pays, JaxConfig(**cfg), jm)
    calls = _Calls(monkeypatch, pk, "embed_both_passes")
    got = tbp.encode_pee_batch(imgs, pays, EncodeConfig(**cfg), mesh,
                               device="cpu")
    assert got.containers == want.containers
    t_start = tbp._start_thresholds(
        torch.from_numpy(imgs), [p.size for p in pays],
        port_model.max_value(int(imgs.max()), 16, 16), cases.F1_THRESHOLD)
    groups = cases.pee_attempt_group_lists(t_start, got.thresholds)
    assert cases.F1_GROUP in groups
    shards = cases.pee_group_shards(groups, dp, mesh.size)
    assert calls.sizes == [n for group in shards for n in group]
    unsharded = tbp.encode_pee_batch(imgs, pays, EncodeConfig(**cfg),
                                     device="cpu")
    assert got.containers == unsharded.containers


# ---------------------------------------------------------------------------
# volumes
# ---------------------------------------------------------------------------


def _volume(seed=5, d=B, h=24, w=40, hi=4095):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = hi * (0.3 + 0.4 * x / w + 0.2 * y / h)
    noise = rng.normal(0, hi / 300 + 1, (d, h, w))
    slope = np.linspace(0, hi * 0.05, d)[:, None, None]
    return np.clip(np.rint(base[None] + noise + slope), 0, hi).astype(
        np.uint16)


@pytest.mark.parametrize("strategy", ["hybrid", "block_adaptive", "pee"])
def test_volume_under_dp_matches_jax(jmesh, monkeypatch, strategy):
    vol = _volume()
    payload = np.random.default_rng(7).integers(0, 2, 3000, dtype=np.uint8)
    cfg = dict(strategy=strategy)
    js, jtotal = jv.volume_cut_point(vol, 0.4, jmesh)
    want = jv.encode_volume(vol, payload, JaxConfig(**cfg), jmesh)
    want_blob = jv.pack_volume(vol, want, JaxConfig(**cfg))
    k1 = _Calls(monkeypatch, rk, "raster_embed_batch")
    k2 = _Calls(monkeypatch, rk, "raster_extract_batch")
    for name in ("dp2", "dp8", "dp4x2"):
        mesh = _mesh(name)
        dp = len(dp_devices(mesh))
        s, total = tv.volume_cut_point(vol, 0.4, mesh, device="cpu")
        assert s == js
        np.testing.assert_array_equal(total, np.asarray(jtotal))
        k1.sizes.clear()
        res = tv.encode_volume(vol, payload, EncodeConfig(**cfg), mesh,
                               device="cpu")
        blob = tv.pack_volume(vol, res, EncodeConfig(**cfg), device="cpu")
        assert blob == want_blob, name
        got_m, want_m = res.metrics, want.metrics
        for k in ("changed_pixels", "max_abs_diff", "max_value"):
            assert got_m[k] == want_m[k], k
        np.testing.assert_allclose(got_m["mean_abs_diff"],
                                   want_m["mean_abs_diff"], rtol=METRIC_RTOL)
        bits, _, original = tv.unpack_volume(blob, device="cpu")
        np.testing.assert_array_equal(bits, payload)
        np.testing.assert_array_equal(original, vol)
        if strategy == "pee":
            continue
        assert k1.sizes == ([B // dp] * dp if strategy == "hybrid" else [])
        if strategy == "block_adaptive":
            continue     # extract_volume reads raster volumes
        k2.sizes.clear()
        np.testing.assert_array_equal(
            tv.extract_volume(res.stego, res.plan, mesh, device="cpu"),
            payload)
        assert k2.sizes == [B // dp] * dp
        np.testing.assert_array_equal(
            np.asarray(jv.extract_volume(res.stego, res.plan, jmesh)),
            payload)


# ---------------------------------------------------------------------------
# decode and refusals
# ---------------------------------------------------------------------------


def test_decode_ragged_mixed_batch_under_dp():
    """Five containers of four groups (raster u16 twice, PEE, block,
    multi_plane u8): no group divides ``dp``. The JAX package decodes them
    under its (4, 2) mesh, the port under each mesh, to the same payloads
    and originals."""
    blobs, wants = [], []
    for strategy, geom, seed in (("hybrid", "u16", 1), ("hybrid", "u16", 2),
                                 ("pee", "u16", 3),
                                 ("block_adaptive", "odd", 4),
                                 ("multi_plane", "u8", 5)):
        img = _images(strategy, geom, seed=seed, b=1)
        pay = _payloads(seed, 1, strategy)
        res = tb.encode_batch_containers(
            img, pay, EncodeConfig(strategy=strategy),
            bits_stored=GEOMS[geom][3], device="cpu")
        blobs += res.containers
        wants.append((img[0], pay[0]))
    jm = jax_mesh.make_mesh(8, ("dp", "tile"), shape=(4, 2))
    want = jb.decode_batch_containers(blobs, jm)
    for name in MESHES:
        got = tb.decode_batch_containers(blobs, _mesh(name), device="cpu")
        for g, w, (img, _) in zip(got, want, wants):
            np.testing.assert_array_equal(g.payload_bits, w.payload_bits)
            np.testing.assert_array_equal(g.original, w.original)
            np.testing.assert_array_equal(g.original, img)


@pytest.mark.parametrize("path", ["containers_raster", "containers_pee",
                                  "encode_batch", "encode_volume"])
def test_uneven_encode_batch_raises_value_error(path):
    """A batch of 6 over a ``dp`` axis of 4: the JAX package's
    ``device_put`` raises ``ValueError``; the port raises it too, naming
    the batch and the ``dp`` size."""
    mesh, jm = _mesh("dp4"), jax_mesh.make_mesh(4, ("dp",))
    strategy = "pee" if path == "containers_pee" else "hybrid"
    imgs = _images(strategy, "u16", b=6)
    pays = _payloads(3, 6, strategy)
    if path.startswith("containers"):
        cfg = dict(strategy=strategy)
        calls = (lambda: jb.encode_batch_containers(
                     imgs, pays, JaxConfig(**cfg), jm, bits_stored=12),
                 lambda: tb.encode_batch_containers(
                     imgs, pays, EncodeConfig(**cfg), mesh, bits_stored=12,
                     device="cpu"))
    elif path == "encode_batch":
        plan = jb.plan_batch(imgs, pays, JaxConfig())
        calls = (lambda: np.asarray(jb.encode_batch(imgs, plan, jm)),
                 lambda: tb.encode_batch(imgs, plan, mesh, device="cpu"))
    else:
        calls = (lambda: jv.encode_volume(imgs, "v", JaxConfig(), jm),
                 lambda: tv.encode_volume(imgs, "v", EncodeConfig(), mesh,
                                          device="cpu"))
    with pytest.raises(ValueError):
        calls[0]()
    with pytest.raises(ValueError, match="batch of 6 .* dp axis of 4"):
        calls[1]()
