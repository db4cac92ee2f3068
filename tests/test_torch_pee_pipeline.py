"""The port's PEE pipeline (on the CPU, through the kernels' plain versions)
against the JAX package's: single-image and batch containers
byte-identical, each side decoding the other's, threshold escalation, the
``max_val`` fallback, uint8 images with BitsStored > 8 (the reference's
wrap past 255 included), the capacity error, the capacity probe, the
copied host functions and the committed parity hashes."""

import numpy as np
import pytest
import torch

import codec_tcc_tpu as jax_pkg
from codec_tcc_tpu.models import pee as jax_model
from codec_tcc_tpu.ops import pee as jax_pee
from codec_tcc_tpu.parallel import batch_pee as jax_batch
from codec_tcc_tpu.utils import pool as jax_pool
import codec_tcc_tpu_torch as port
from codec_tcc_tpu_torch.io.container import parse_pee_ext
from codec_tcc_tpu_torch.models import pee as port_model
from codec_tcc_tpu_torch.parallel import batch_pee as port_batch
from codec_tcc_tpu_torch.utils import pool as port_pool

import torch_port_cases as cases
from torch_parity import same_code

torch.set_num_threads(1)

PEE = dict(strategy="pee")


def _image(h, w, dtype, bits_stored, seed):
    return cases.image(cases.Case("t", h, w, np.dtype(dtype).name,
                                  bits_stored, "text", "pee", seed))


def _both(img, bits, bits_stored, **cfg):
    res_p = port.encode_array(img, bits, port.EncodeConfig(**PEE, **cfg),
                              bits_stored=bits_stored, device="cpu")
    res_j = jax_pkg.encode_array(img, bits, jax_pkg.EncodeConfig(**PEE, **cfg),
                                 bits_stored=bits_stored)
    return res_p, res_j


def _hist_threshold(img, nbits, max_val, t_min=2):
    caps = [jax_pee.capacities_by_threshold(
        jax_pee.capacity_histogram(img, p, 128, max_val)) for p in (0, 1)]
    return jax_model.select_threshold(caps[0], caps[1], nbits, t_min)


@pytest.mark.parametrize("h,w,dtype,bits_stored,nbits,escalates", [
    (48, 40, np.uint16, 12, 304, True),
    (40, 48, np.uint8, 8, 1134, True),
    (40, 48, np.uint8, 8, 500, False),
    (37, 53, np.uint8, 8, 0, False),
], ids=["u16-escalates", "u8-escalates", "u8", "odd-empty"])
def test_pee_encode_byte_identical_and_cross_decode(h, w, dtype, bits_stored,
                                                    nbits, escalates):
    img = _image(h, w, dtype, bits_stored, seed=100)
    bits = np.random.default_rng(nbits).integers(0, 2, nbits, dtype=np.uint8)
    res_p, res_j = _both(img, bits, bits_stored)
    assert res_p.container == res_j.container
    np.testing.assert_array_equal(res_p.stego, res_j.stego)
    assert res_p.s == res_j.s == 0
    assert res_p.metrics["changed_pixels"] == res_j.metrics["changed_pixels"]
    t_final = parse_pee_ext(res_p.meta.ext)[0]
    t_hist = _hist_threshold(img, nbits, (1 << bits_stored) - 1)
    assert (t_final > t_hist) == escalates

    for dec in (port.decode_container(res_j.container, device="cpu"),
                jax_pkg.decode_container(res_p.container)):
        np.testing.assert_array_equal(dec.payload_bits, bits)
        np.testing.assert_array_equal(dec.stego, res_j.stego)
        np.testing.assert_array_equal(dec.original, img)


def test_pee_max_val_falls_back_to_the_dtype():
    """An image above its BitsStored embeds against the dtype's ceiling."""
    img = _image(40, 40, np.uint16, 12, seed=101)
    img[7, 9] = 5000
    bits = np.random.default_rng(5).integers(0, 2, 200, dtype=np.uint8)
    res_p, res_j = _both(img, bits, 12)
    assert res_p.container == res_j.container
    assert res_p.meta.bits_stored == 12
    dec = port.decode_container(res_p.container, device="cpu")
    np.testing.assert_array_equal(dec.original, img)


def _u8_phantom(peak, seed, h=32, w=32):
    """A smooth uint8 phantom whose brightest pixel is ``peak``."""
    img = _image(h, w, np.uint16, 12, seed).astype(np.float64)
    return np.rint(img * peak / img.max()).astype(np.uint8)


def _u8_bright(seed, h=32, w=32):
    """A smooth uint8 phantom squeezed into 238-255."""
    img = _image(h, w, np.uint8, 8, seed).astype(np.int32)
    return (238 + img * 17 // 255).astype(np.uint8)


@pytest.mark.parametrize("peak,bits_stored,nbits,seed", [
    (120, 12, 300, 142), (200, 9, 500, 139), (255, 16, 100, 145)],
    ids=["peak120-bs12", "peak200-bs9", "peak255-bs16"])
def test_pee_u8_above_8_bits_stored_matches_jax(peak, bits_stored, nbits,
                                                seed):
    """A uint8 image whose BitsStored exceeds 8 embeds against
    ``2**bits_stored - 1``, as in the JAX package: the same container, and
    both decodes give the payload and the original back."""
    img = _u8_phantom(peak, seed)
    bits = np.random.default_rng(nbits).integers(0, 2, nbits, dtype=np.uint8)
    res_p, res_j = _both(img, bits, bits_stored)
    assert res_p.container == res_j.container
    assert res_p.meta.bits_stored == bits_stored
    for dec in (port.decode_container(res_p.container, device="cpu"),
                jax_pkg.decode_container(res_j.container)):
        np.testing.assert_array_equal(dec.payload_bits, bits)
        np.testing.assert_array_equal(dec.original, img)


@pytest.mark.parametrize("bits_stored", [9, 12, 16])
def test_pee_batch_u8_above_8_bits_stored_matches_jax(bits_stored):
    imgs = np.stack([_u8_phantom(peak, seed=140 + i)
                     for i, peak in enumerate((120, 200, 255))])
    rng = np.random.default_rng(bits_stored)
    pays = [rng.integers(0, 2, n, dtype=np.uint8) for n in (100, 300, 500)]
    res_p = port_batch.encode_pee_batch(
        imgs, pays, port.EncodeConfig(**PEE), bits_stored=bits_stored,
        device="cpu")
    res_j = jax_batch.encode_pee_batch(
        imgs, pays, jax_pkg.EncodeConfig(**PEE), bits_stored=bits_stored)
    assert res_p.containers == res_j.containers
    decs_p = port_batch.decode_pee_batch(res_p.containers, device="cpu")
    decs_j = jax_batch.decode_pee_batch(res_j.containers)
    for dec_p, dec_j in zip(decs_p, decs_j):
        np.testing.assert_array_equal(dec_p.payload_bits, dec_j.payload_bits)
        np.testing.assert_array_equal(dec_p.original, dec_j.original)


def test_pee_u8_bright_wraps_like_jax():
    """The reference fault, copied on purpose: on a bright uint8 image with
    BitsStored 12, the JAX package's PEE embeds against 4095, so expanded
    pixels wrap past 255 and its container does not decode to the payload
    or the original. The port gives the same bytes and the same wrong
    decode."""
    img = _u8_bright(seed=150)
    bits = np.random.default_rng(400).integers(0, 2, 400, dtype=np.uint8)
    res_p, res_j = _both(img, bits, 12)
    assert res_p.container == res_j.container
    assert int(res_j.stego.min()) < 238          # wrapped past 255
    dec_p = port.decode_container(res_p.container, device="cpu")
    dec_j = jax_pkg.decode_container(res_j.container)
    np.testing.assert_array_equal(dec_p.payload_bits, dec_j.payload_bits)
    np.testing.assert_array_equal(dec_p.original, dec_j.original)
    assert not (np.array_equal(dec_j.payload_bits, bits)
                and np.array_equal(dec_j.original, img))


def test_pee_capacity_error_at_the_largest_threshold():
    img = _image(16, 16, np.uint8, 8, seed=102)
    bits = np.ones(2000, np.uint8)
    with pytest.raises(port.CapacityError, match="T=128"):
        port.encode_array(img, bits, port.EncodeConfig(**PEE), bits_stored=8,
                          device="cpu")
    with pytest.raises(jax_pkg.CapacityError, match="T=128"):
        jax_pkg.encode_array(img, bits, jax_pkg.EncodeConfig(**PEE),
                             bits_stored=8)


def test_pee_host_policy_encodes_as_in_jax():
    """device_policy='host' does not apply to PEE, in either package."""
    img = _image(32, 32, np.uint16, 12, seed=103)
    res_p, res_j = _both(img, cases.TEXT_PAYLOAD, 12, device_policy="host")
    assert res_p.container == res_j.container


def test_pee_batch_byte_identical_with_mixed_thresholds():
    imgs = np.stack([_image(48, 40, np.uint16, 12, seed=110 + i)
                     for i in range(4)])
    rng = np.random.default_rng(6)
    pays = [rng.integers(0, 2, n, dtype=np.uint8) for n in (100, 900, 400)]
    pays.append(cases.TEXT_PAYLOAD)
    res_p = port_batch.encode_pee_batch(
        imgs, pays, port.EncodeConfig(**PEE), bits_stored=12, device="cpu")
    res_j = jax_batch.encode_pee_batch(
        imgs, pays, jax_pkg.EncodeConfig(**PEE), bits_stored=12)
    assert len(set(res_p.thresholds.tolist())) > 1
    np.testing.assert_array_equal(res_p.thresholds, res_j.thresholds)
    np.testing.assert_array_equal(res_p.used_bits, res_j.used_bits)
    np.testing.assert_array_equal(res_p.stego, res_j.stego)
    assert res_p.containers == res_j.containers

    decs = port_batch.decode_pee_batch(res_j.containers, device="cpu")
    decs_j = jax_batch.decode_pee_batch(res_p.containers)
    for i, pay in enumerate(pays):
        want = (np.unpackbits(np.frombuffer(pay.encode(), np.uint8))
                if isinstance(pay, str) else pay)
        for dec in (decs[i], decs_j[i]):
            np.testing.assert_array_equal(dec.payload_bits, want)
            np.testing.assert_array_equal(dec.original, imgs[i])


@pytest.mark.parametrize("batch", [False, True], ids=["single", "batch"])
def test_pee_kernel_calls_follow_the_attempt_groups(monkeypatch, batch):
    """The wrappers are called twice per equal-T attempt group on encode
    and twice per threshold group on decode: the exact launch counts that
    ``chip_smoke.py`` and ``tests/test_torch_cuda.py`` require on the GPU."""
    from codec_tcc_tpu_torch.ops import pee_kernels as pk

    calls = {"pee_embed": 0, "pee_extract": 0}
    for name in calls:
        def counted(*args, _name=name, _fn=getattr(pk, name)):
            calls[_name] += 1
            return _fn(*args)
        monkeypatch.setattr(pk, name, counted)
    cfg = port.EncodeConfig(**PEE)
    if batch:
        imgs = np.stack([_image(48, 40, np.uint16, 12, seed=110 + i)
                         for i in range(4)])
        rng = np.random.default_rng(6)
        pays = [rng.integers(0, 2, n, dtype=np.uint8) for n in (100, 900, 400)]
        pays.append(cases.TEXT_PAYLOAD)
        res = port_batch.encode_pee_batch(imgs, pays, cfg, bits_stored=12,
                                          device="cpu")
        t_final = res.thresholds
        want = [port.pipeline._as_payload_bits(p).size for p in pays]
        encoded = calls["pee_embed"]
        port_batch.decode_pee_batch(res.containers, device="cpu")
    else:
        imgs = _image(48, 40, np.uint16, 12, seed=100)[None]
        want = [304]
        bits = np.random.default_rng(304).integers(0, 2, 304, dtype=np.uint8)
        res = port.encode_array(imgs[0], bits, cfg, bits_stored=12,
                                device="cpu")
        t_final = [parse_pee_ext(res.meta.ext)[0]]
        encoded = calls["pee_embed"]
        port.decode_container(res.container, device="cpu")
    t_start = port_batch._start_thresholds(
        torch.from_numpy(imgs), want, port_model.max_value(
            int(imgs.max()), 16, 12), cfg.pee_threshold)
    groups = cases.pee_attempt_groups(t_start, t_final)
    assert groups > len(set(np.asarray(t_final).tolist()))   # T escalated
    assert encoded == 2 * groups
    assert calls == {"pee_embed": 2 * groups,
                     "pee_extract": 2 * len(set(np.asarray(t_final).tolist()))}


@pytest.mark.parametrize("t", [2, 9])
def test_probe_capacity_batch_matches_jax(t):
    imgs = np.stack([_image(40, 48, np.uint8, 8, seed=120 + i)
                     for i in range(3)])
    np.testing.assert_array_equal(
        port_batch.probe_capacity_batch(imgs, t, 255, device="cpu"),
        jax_batch.probe_capacity_batch(imgs, t, 255))


def test_batch_refuses_a_mesh_and_foreign_containers():
    """A batch that does not split evenly over the mesh's ``dp`` axis
    raises ``ValueError``, as the JAX package's ``device_put`` does."""
    from codec_tcc_tpu.parallel import mesh as jax_mesh
    from codec_tcc_tpu_torch.parallel.mesh import make_mesh

    imgs = np.zeros((1, 8, 8), np.uint8)
    with pytest.raises(ValueError):
        jax_batch.encode_pee_batch(imgs, ["x"], mesh=jax_mesh.make_mesh(2))
    with pytest.raises(ValueError, match="does not split evenly"):
        port_batch.encode_pee_batch(
            imgs, ["x"], mesh=make_mesh(devices=["cpu"] * 2), device="cpu")
    raster = port.encode_array(_image(16, 16, np.uint8, 8, seed=1), "x",
                               bits_stored=8, device="cpu").container
    with pytest.raises(ValueError, match="not a PEE container"):
        port_batch.decode_pee_batch([raster], device="cpu")


@pytest.mark.parametrize("port_obj,jax_obj", [
    (port_model.select_threshold, jax_model.select_threshold),
    (port_model.parse_pee_container_parts, jax_model.parse_pee_container_parts),
    (port_pool.host_workers, jax_pool.host_workers),
], ids=["select_threshold", "parse_pee_container_parts", "host_workers"])
def test_copied_host_functions_are_the_same_code(port_obj, jax_obj):
    assert same_code(port_obj, jax_obj)


@pytest.mark.parametrize("name", ["pee_mr512_u16_text", "pee_ot512_u8_100k"])
def test_pee_parity_fixture_regenerates(name):
    """Both packages reproduce the committed hashes the GPU run checks."""
    case = cases.BY_NAME[name]
    want = cases.load_parity()[name]
    img = cases.image(case)
    bits = cases.payload_bits(case, 0)
    assert cases.sha256(bits) == want["payload_sha256"]
    res_p, res_j = _both(img, bits, case.bits_stored)
    for res in (res_j, res_p):
        assert res.s == want["s"] == 0
        assert list(parse_pee_ext(res.meta.ext)) == want["pee_ext"]
        assert len(res.container) == want["container_len"]
        assert cases.sha256(res.container) == want["container_sha256"]


def test_pee_batch_group_with_a_duplicate_matches_jax():
    """F1: a round's group of B entries can hold an image twice (one that
    fell short at T and at T + 1 in one round). The port gathers the
    message rows by the group's indices, as the JAX package does, so the
    containers are the JAX package's bytes; both packages' whole-batch
    image shortcut then embeds image k with the message of ``idxs[k]``
    (F1-ref, the reference's behaviour, pinned here): every container
    decodes to its own payload, and the one written from another image's
    pixels restores that image."""
    imgs, pays = cases.f1_batch()
    cfg = dict(strategy="pee", pee_threshold=cases.F1_THRESHOLD)
    res_p = port_batch.encode_pee_batch(imgs, pays, port.EncodeConfig(**cfg),
                                        device="cpu")
    res_j = jax_batch.encode_pee_batch(imgs, pays, jax_pkg.EncodeConfig(**cfg))
    t_start = port_batch._start_thresholds(
        torch.from_numpy(imgs), [p.size for p in pays],
        port_model.max_value(int(imgs.max()), 16, 16), cases.F1_THRESHOLD)
    groups = cases.pee_attempt_group_lists(t_start, res_p.thresholds)
    t_dup, idxs = cases.F1_GROUP
    assert (t_dup, idxs) in groups and len(idxs) == len(imgs)
    assert res_p.containers == res_j.containers
    decoded = port_batch.decode_pee_batch(res_p.containers, device="cpu")
    for i, dec in enumerate(decoded):
        np.testing.assert_array_equal(dec.payload_bits, pays[i])
    # the last write of each image in the duplicate group: image idxs[k]
    # keeps the stego of image k
    source = {i: k for k, i in enumerate(idxs)}
    for i, dec in enumerate(decoded):
        np.testing.assert_array_equal(dec.original, imgs[source.get(i, i)])
    assert source[0] == 1       # image 0 restores image 1 (F1-ref)
