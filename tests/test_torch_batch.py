"""The port's batch path (``codec_tcc_tpu_torch.parallel.batch``,
``parallel.runner``, ``pipeline.encode_file``) against the JAX package's on
the CPU, on the same numpy inputs from a seed: the planner, the batch embed
and extract, the block batch helpers, the quality reports, the container
batch encoder (byte-identical containers over strategy, device policy,
metrics and ``H*W % 8 != 0``) and decoder (a mixed-key batch: identical
payload bits and originals), the runner's containers and manifest; and
every copied function held to its original (``tests/torch_parity.py``).
"""

import json

import numpy as np
import pytest
import torch

from codec_tcc_tpu import pipeline as jax_pipeline
from codec_tcc_tpu.config import EncodeConfig as JaxConfig
from codec_tcc_tpu.parallel import batch as jb
from codec_tcc_tpu.parallel import runner as jax_runner
from codec_tcc_tpu_torch import pipeline as port_pipeline
from codec_tcc_tpu_torch.config import EncodeConfig
from codec_tcc_tpu_torch.io import dicom
from codec_tcc_tpu_torch.ops import blocks as block_ops
from codec_tcc_tpu_torch.ops import metrics as metric_ops
from codec_tcc_tpu_torch.ops import raster_kernels as rk
from codec_tcc_tpu_torch.parallel import batch as tb
from codec_tcc_tpu_torch.parallel import runner as port_runner

from torch_parity import same_code, same_code_but_device

torch.set_num_threads(1)

# the tolerances of tests/test_torch_ops.py: float32 moments summed in
# another order than XLA's (2e-5), global SSIM from their differences (an
# absolute 5e-5), the reports' other floats 1e-6; integer fields are exact
MOMENT_RTOL = 2e-5
SSIM_ATOL = 5e-5
REPORT_RTOL = 1e-6


def _assert_reports_match(got, want):
    assert got.keys() == want.keys()
    for k in ("changed_pixels", "max_abs_diff", "max_value"):
        assert got[k] == want[k], k
    for k in ("mse", "psnr", "mean_abs_diff", "changed_percent"):
        np.testing.assert_allclose(got[k], want[k], rtol=REPORT_RTOL,
                                   err_msg=k)
    assert abs(got["ssim"] - want["ssim"]) <= SSIM_ATOL


def _images(seed, b, h, w, dtype):
    rng = np.random.default_rng(seed)
    hi = 4096 if dtype == np.uint16 else 256
    y, x = np.mgrid[0:h, 0:w]
    base = (x * 37 + y * 11) % hi
    noise = rng.integers(0, hi // 8, (b, h, w))
    return ((base[None] + noise) % hi).astype(dtype)


def _payloads(seed, b):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(b):
        kind = i % 3
        if kind == 0:
            out.append("batch message %d" % i)
        elif kind == 1:
            out.append(bytes(rng.integers(0, 256, 7 + 5 * i, dtype=np.uint8)))
        else:
            out.append(rng.integers(0, 2, 41 + 13 * i).astype(np.uint8))
    return out


def _bits_stored(dtype):
    return 12 if dtype == np.uint16 else None


# ---------------------------------------------------------------------------
# copied code
# ---------------------------------------------------------------------------

SAME = [
    (tb.BatchPlan, jb.BatchPlan),
    (tb.plan_batch, jb.plan_batch),
    (tb._msg_prefix, jb._msg_prefix),
    (tb.hybrid_base_offsets_host, jb.hybrid_base_offsets_host),
    (tb.BatchEncodeResult, jb.BatchEncodeResult),
    (tb._pack_batch_result, jb._pack_batch_result),
    (tb._group_decode_stegos, jb._group_decode_stegos),
    (tb._decode_block_group, jb._decode_block_group),
    (tb._decode_raster_group, jb._decode_raster_group),
    (port_runner.ItemResult, jax_runner.ItemResult),
    (port_pipeline._next_pow2, jax_pipeline._next_pow2),
]

SAME_BUT_DEVICE = [
    (port_pipeline.encode_file, jax_pipeline.encode_file),
    (port_runner.BatchRunner, jax_runner.BatchRunner),
]


@pytest.mark.parametrize("port_obj,jax_obj", SAME,
                         ids=[p.__name__ for p, _ in SAME])
def test_copied_batch_code_is_the_same(port_obj, jax_obj):
    assert same_code(port_obj, jax_obj)


@pytest.mark.parametrize("port_obj,jax_obj", SAME_BUT_DEVICE,
                         ids=[p.__name__ for p, _ in SAME_BUT_DEVICE])
def test_copied_code_differs_only_by_device(port_obj, jax_obj):
    assert not same_code(port_obj, jax_obj)
    assert same_code_but_device(port_obj, jax_obj)


# ---------------------------------------------------------------------------
# planning
# ---------------------------------------------------------------------------

GEOMS = [(3, 32, 48, np.uint16), (3, 17, 23, np.uint8)]
GEOM_IDS = ["32x48_u16", "17x23_u8"]


@pytest.mark.parametrize("b,h,w,dtype", GEOMS, ids=GEOM_IDS)
def test_batched_histograms_and_hybrid_offsets_match_jax(b, h, w, dtype):
    imgs = _images(1, b, h, w, dtype)
    nbins = 256 if dtype == np.uint8 else 65536
    np.testing.assert_array_equal(
        tb.batched_histograms(imgs, nbins, device="cpu"),
        np.asarray(jb.batched_histograms(imgs, nbins)))
    for bs in (8, 16):
        want = jb.hybrid_base_offsets(imgs, h, w, bs)
        assert tb.hybrid_base_offsets(imgs, h, w, bs, device="cpu") == want
        assert tb.hybrid_base_offsets(torch.from_numpy(imgs), h, w, bs) == want
        assert tb.hybrid_base_offsets_host(imgs, h, w, bs) == want


@pytest.mark.parametrize("strategy", ["multi_plane", "hybrid",
                                      "block_adaptive"])
@pytest.mark.parametrize("b,h,w,dtype", GEOMS, ids=GEOM_IDS)
def test_plan_batch_matches_jax(b, h, w, dtype, strategy):
    imgs = _images(2, b, h, w, dtype)
    pays = _payloads(3, b)
    nbins = 256 if dtype == np.uint8 else 65536
    cfg = dict(strategy=strategy, beta=0.6)
    want = jb.plan_batch(imgs, pays, JaxConfig(**cfg), nbits=12)
    hists = tb.batched_histograms(imgs, nbins, device="cpu")
    offsets = (tb.hybrid_base_offsets(imgs, h, w, 16, device="cpu")
               if strategy == "hybrid" else None)
    got = tb.plan_batch(imgs, pays, EncodeConfig(**cfg), histograms=hists,
                        nbits=12, base_offsets=offsets)
    for field in ("s", "starts", "lengths", "offsets", "msgs",
                  "payload_bits", "base_offsets"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field), err_msg=field)
    assert (got.nbits, got.lpad, got.align, got.seed) == (
        want.nbits, want.lpad, want.align, want.seed)
    np.testing.assert_array_equal(tb._msg_prefix(got), jb._msg_prefix(want))


def test_plan_batch_without_histograms_needs_the_card():
    """Without precomputed histograms the planner counts on the device,
    which is the card unless a caller hands it a CPU tensor's values."""
    imgs = _images(4, 2, 16, 16, np.uint8)
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the planner would run there")
    with pytest.raises(RuntimeError, match="cuda"):
        tb.plan_batch(imgs, ["a", "b"], EncodeConfig())


# ---------------------------------------------------------------------------
# batch embed / extract (K1 and K2 batch, plain versions on the CPU)
# ---------------------------------------------------------------------------


def _plan(imgs, pays, strategy="hybrid"):
    return jb.plan_batch(imgs, pays, JaxConfig(strategy=strategy, beta=0.7),
                         nbits=12)


@pytest.mark.parametrize("strategy", ["multi_plane", "hybrid"])
@pytest.mark.parametrize("b,h,w,dtype", GEOMS, ids=GEOM_IDS)
def test_encode_and_extract_batch_match_jax(b, h, w, dtype, strategy):
    imgs = _images(5, b, h, w, dtype)
    pays = _payloads(6, b)
    plan = _plan(imgs, pays, strategy)
    want = np.array(jb.encode_batch(imgs, plan))
    rk.reset_launch_counts()
    for backend in ("auto", "packed", "preplaced", "pallas", "xla"):
        got = tb.encode_batch(imgs, plan, backend=backend, device="cpu")
        assert got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), want, err_msg=backend)

    for out_len in (None, int(plan.payload_bits.max()), 5):
        want_bits = np.asarray(jb.extract_batch(want, plan, out_len=out_len))
        got_bits = tb.extract_batch(want, plan, out_len=out_len,
                                    device="cpu")
        np.testing.assert_array_equal(got_bits, want_bits)
    for i in range(b):
        n_i = int(plan.payload_bits[i])
        msg = tb.extract_batch(torch.from_numpy(want), plan,
                               out_len=n_i, device="cpu")[i]
        np.testing.assert_array_equal(msg, plan.msgs[i, :n_i])

    want_al = np.asarray(jb.extract_aligned_batch(want, plan))
    got_al = tb.extract_aligned_batch(want, plan, device="cpu")
    np.testing.assert_array_equal(got_al.numpy(), want_al)
    assert set(rk.LAUNCHES.values()) == {0}     # plain versions only


def test_batch_entry_points_refuse_a_mesh():
    imgs = _images(7, 2, 16, 16, np.uint8)
    plan = _plan(imgs, ["a", "b"])
    for call in (
        lambda: tb.encode_batch(imgs, plan, mesh=object(), device="cpu"),
        lambda: tb.extract_batch(imgs, plan, mesh=object(), device="cpu"),
        lambda: tb.encode_batch_containers(imgs, ["a", "b"], EncodeConfig(),
                                           mesh=object(), device="cpu"),
        lambda: tb.decode_batch_containers([b"x"], mesh=object(),
                                           device="cpu"),
    ):
        with pytest.raises(NotImplementedError, match="multi-device"):
            call()


# ---------------------------------------------------------------------------
# block batch helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("block", [4, 6])
@pytest.mark.parametrize("b,h,w,dtype", GEOMS, ids=GEOM_IDS)
def test_block_batch_helpers_match_jax(b, h, w, dtype, block):
    import jax.numpy as jnp

    imgs = _images(8, b, h, w, dtype)
    pays = _payloads(9, b)
    plan = _plan(imgs, pays, "block_adaptive")
    np.testing.assert_array_equal(
        block_ops.block_bit_counts_all(torch.from_numpy(imgs), 3,
                                       block).numpy(),
        np.asarray(jb._batch_block_counts_jit(jnp.asarray(imgs), 3, block)))
    bases = tb._batch_block_bases(torch.from_numpy(imgs), plan.nbits,
                                  plan.s, block, h, w)
    want_bases = jb._batch_block_bases(jnp.asarray(imgs), plan.nbits,
                                       plan.s, block, h, w)
    np.testing.assert_array_equal(bases, want_bases)
    want = np.array(jb._block_embed_batch(
        jnp.asarray(imgs), jnp.asarray(plan.msgs), jnp.asarray(want_bases),
        jnp.asarray(plan.lengths), jnp.asarray(plan.offsets),
        jnp.asarray(plan.s), plan.nbits, block))
    got = tb._block_embed_batch(
        torch.from_numpy(imgs), torch.from_numpy(tb._msg_prefix(plan)),
        bases, plan.lengths, plan.offsets, plan.s, plan.nbits, block)
    np.testing.assert_array_equal(got.numpy(), want)
    out_len = int(plan.payload_bits.max())
    want_bits = np.asarray(jb._block_extract_batch(
        jnp.asarray(want), jnp.asarray(want_bases),
        jnp.asarray(plan.lengths), jnp.asarray(plan.offsets),
        jnp.asarray(plan.s), plan.nbits, block, out_len))
    got_bits = tb._block_extract_batch(
        torch.from_numpy(want), bases, plan.lengths, plan.offsets, plan.s,
        plan.nbits, block, out_len)
    np.testing.assert_array_equal(got_bits.numpy(), want_bits)


def test_batch_quality_reports_match_jax():
    imgs = _images(10, 3, 24, 40, np.uint16)
    stego = imgs ^ (_images(11, 3, 24, 40, np.uint16) & 3).astype(np.uint16)
    imgs[:, 0, 0] = stego[:, 0, 0] = 4095  # equal ranges: no rescaling
    stego[1] = imgs[1]                     # an unchanged image: PSNR inf
    got = tb._batch_quality_reports(imgs, stego, torch.device("cpu"))
    want = jb._batch_quality_reports(imgs, stego)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        _assert_reports_match(g, w)
    stats = metric_ops.pair_stats(torch.from_numpy(imgs),
                                  torch.from_numpy(stego))
    want_stats = jb._pair_stats_batch_jit(imgs, stego)
    for k, v in stats.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(want_stats[k]),
                                   rtol=MOMENT_RTOL, err_msg=k)


# ---------------------------------------------------------------------------
# container batch encode / decode
# ---------------------------------------------------------------------------


def _encode_both(imgs, pays, cfg, bits_stored):
    """(JAX result or exception, port result or exception)."""
    out = []
    for call in (
        lambda: jb.encode_batch_containers(imgs, pays, JaxConfig(**cfg),
                                           bits_stored=bits_stored),
        lambda: tb.encode_batch_containers(imgs, pays, EncodeConfig(**cfg),
                                           bits_stored=bits_stored,
                                           device="cpu"),
    ):
        try:
            out.append(call())
        except (ValueError, RuntimeError) as exc:
            out.append(exc)
    return out


@pytest.mark.parametrize("metrics", [True, False], ids=["metrics",
                                                         "no_metrics"])
@pytest.mark.parametrize("policy", ["device", "host"])
@pytest.mark.parametrize("strategy", ["multi_plane", "hybrid",
                                      "block_adaptive", "pee"])
@pytest.mark.parametrize("b,h,w,dtype", GEOMS, ids=GEOM_IDS)
def test_encode_batch_containers_match_jax(b, h, w, dtype, strategy, policy,
                                           metrics):
    """Byte-identical containers and equal stegos; where the JAX package
    refuses (a forced host route the window form cannot serve: block, or
    ``H*W % 8 != 0``), the port refuses with the same message."""
    imgs = _images(12, b, h, w, dtype)
    pays = _payloads(13, b)
    cfg = dict(strategy=strategy, device_policy=policy,
               compute_metrics=metrics, beta=0.6)
    want, got = _encode_both(imgs, pays, cfg, _bits_stored(dtype))
    if isinstance(want, Exception):
        assert type(got).__name__ == type(want).__name__
        assert str(got) == str(want)
        assert policy == "host"
        return
    assert not isinstance(got, Exception), got
    assert got.containers == want.containers
    np.testing.assert_array_equal(got.stego, want.stego)
    if strategy == "pee":
        assert got.plan is None and want.plan is None
    else:
        np.testing.assert_array_equal(got.plan.s, want.plan.s)
    assert (got.metrics is None) == (want.metrics is None) == (not metrics)
    for g, w in zip(got.metrics or [], want.metrics or []):
        _assert_reports_match(g, w)
    # the single-image pipeline writes the same bytes
    single = port_pipeline.encode_array(
        imgs[1], pays[1], EncodeConfig(**cfg),
        bits_stored=_bits_stored(dtype), device="cpu")
    assert single.container == got.containers[1]


def test_encode_batch_containers_refusals_match_jax():
    imgs = _images(14, 2, 16, 16, np.uint8)
    for cfg, exc in ((dict(container_version=1), ValueError),
                     (dict(strategy="hybrid", beta=0.01), ValueError)):
        want, got = _encode_both(imgs, ["x" * 200, "y"], cfg, None)
        assert isinstance(want, exc)
        assert type(got).__name__ == type(want).__name__
        assert str(got) == str(want)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        tb.encode_batch_containers(imgs, ["a", "b"],
                                   EncodeConfig(codec="png"), device="cpu")


def _mixed_containers():
    """JAX-written containers of four group keys, interleaved: raster u16
    (two strategies), block_adaptive u8 odd geometry, PEE u16, and a raster
    group without bitmaps."""
    conts, imgs = [], []
    specs = [
        (dict(strategy="hybrid"), _images(20, 2, 32, 48, np.uint16), 12),
        (dict(strategy="multi_plane"), _images(21, 2, 32, 48, np.uint16), 12),
        (dict(strategy="block_adaptive"), _images(22, 2, 17, 23, np.uint8),
         None),
        (dict(strategy="pee"), _images(23, 2, 32, 48, np.uint16), 12),
        (dict(strategy="hybrid", store_bitmaps=False),
         _images(24, 1, 24, 40, np.uint8), None),
    ]
    for k, (cfg, im, bs) in enumerate(specs):
        r = jb.encode_batch_containers(im, _payloads(30 + k, im.shape[0]),
                                       JaxConfig(**cfg), bits_stored=bs)
        conts.extend(r.containers)
        imgs.extend(im)
    order = [0, 4, 2, 6, 1, 8, 3, 5, 7]
    return [conts[i] for i in order], [imgs[i] for i in order]


@pytest.mark.parametrize("restore", [True, False])
def test_decode_batch_containers_mixed_keys_match_jax(restore):
    conts, imgs = _mixed_containers()
    want = jb.decode_batch_containers(conts, restore_original=restore)
    got = tb.decode_batch_containers(conts, restore_original=restore,
                                     device="cpu")
    assert len(got) == len(want) == len(conts)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g.payload_bits, w.payload_bits)
        np.testing.assert_array_equal(g.stego, w.stego)
        assert g.meta.strategy == w.meta.strategy
        if w.original is None:
            assert g.original is None
        else:
            np.testing.assert_array_equal(g.original, w.original)
            np.testing.assert_array_equal(g.original, imgs[i])


def test_decode_batch_containers_unported_groups_raise():
    imgs = _images(25, 1, 16, 16, np.uint8)
    v1 = jax_pipeline.encode_array(
        imgs[0], "v1", JaxConfig(container_version=1, codec="png",
                                 store_bitmaps=True)).container
    with pytest.raises(NotImplementedError, match="not yet ported"):
        tb.decode_batch_containers([v1], device="cpu")
    with pytest.raises(ValueError, match="empty container batch"):
        tb.decode_batch_containers([], device="cpu")


# ---------------------------------------------------------------------------
# encode_file and the runner
# ---------------------------------------------------------------------------


def _write_inputs(tmp_path):
    """Two DICOMs (BitsStored 12 and 8) and a PNG."""
    from PIL import Image

    paths = []
    a = _images(40, 1, 24, 32, np.uint16)[0]
    dicom.save_image(a, str(tmp_path / "a.dcm"), bits_stored=12)
    b = _images(41, 1, 20, 20, np.uint8)[0]
    dicom.save_image(b, str(tmp_path / "b.dcm"))
    Image.fromarray(_images(42, 1, 16, 24, np.uint8)[0]).save(
        tmp_path / "c.png")
    for name in ("a.dcm", "b.dcm", "c.png"):
        paths.append(str(tmp_path / name))
    return paths


def test_encode_file_matches_jax(tmp_path):
    for path in _write_inputs(tmp_path):
        for cfg in (dict(), dict(strategy="pee")):
            want = jax_pipeline.encode_file(path, "file", JaxConfig(**cfg))
            got = port_pipeline.encode_file(path, "file",
                                            EncodeConfig(**cfg),
                                            device="cpu")
            assert got.container == want.container, path


def test_batch_runner_matches_jax(tmp_path):
    """The same containers, the same manifest rows (times aside), and a
    resumed run skips the finished items."""
    paths = _write_inputs(tmp_path)
    bad = tmp_path / "bad.png"
    bad.write_bytes(b"not an image")
    paths.append(str(bad))
    cfg = dict(strategy="multi_plane")
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    want = jax_runner.BatchRunner(str(jax_dir), JaxConfig(**cfg)).run(
        paths, "runner")
    runner = port_runner.BatchRunner(str(port_dir), EncodeConfig(**cfg),
                                     device="cpu")
    got = runner.run(paths, "runner")
    assert [r.status for r in got] == ["done", "done", "done", "failed"]
    for g, w in zip(got, want):
        gd, wd = dict(vars(g)), dict(vars(w))
        for row in (gd, wd):
            row.pop("elapsed_s")
            row["output"] = row["output"].rsplit("/", 1)[-1]
        g_psnr, w_psnr = gd.pop("psnr"), wd.pop("psnr")
        assert gd == wd
        assert (g_psnr is None) == (w_psnr is None)
        if w_psnr is not None:
            np.testing.assert_allclose(g_psnr, w_psnr, rtol=REPORT_RTOL)
        if g.status == "done":
            with open(g.output, "rb") as f1, open(w.output, "rb") as f2:
                assert f1.read() == f2.read()
    with open(runner.manifest_path) as f:
        rows = json.load(f)["items"]
    assert [r["status"] for r in rows] == ["done", "done", "done", "failed"]
    assert runner.pending == [str(bad)]
    again = port_runner.BatchRunner(str(port_dir), EncodeConfig(**cfg),
                                    device="cpu")
    assert [r.elapsed_s for r in again.run(paths, "runner")[:3]] == [
        r.elapsed_s for r in got[:3]]
