"""The port's volume path (``codec_tcc_tpu_torch.parallel.volume``: the
global cut point, ``encode_volume`` + ``pack_volume`` to STGV,
``unpack_volume``, ``extract_volume``) against the JAX package's on the
CPU, on the same seeded numpy volumes: byte-identical STGV files for every
strategy on uint16 (4 x 24x40) and on uint8 with ``H*W % 8 != 0``
(3 x 17x19, raw maps), at a text payload and near capacity; exact decodes;
the same errors; the committed ``golden_block_volume.stgv``; and the copied
functions held to their originals (``tests/torch_parity.py``).

Tolerances: the volume quality report comes from float32 moments summed in
another order than XLA's. Where the volume's maximum is unchanged (the
equal-range branch) every float of the report agrees within rtol 1e-4;
where it changes, the range normalisation takes ``mse`` and ``ssim`` from
differences of moments that cancel in float32 in both packages, so only
the moments that do not cancel are compared (the changed pixels and the
maxima exactly, the mean absolute difference within rtol 1e-4).
"""

import os
import struct

import numpy as np
import pytest
import torch

from codec_tcc_tpu import cli as jax_cli
from codec_tcc_tpu.config import EncodeConfig as JaxConfig
from codec_tcc_tpu.errors import CapacityError as JaxCapacityError
from codec_tcc_tpu.ops import pee as jax_pee
from codec_tcc_tpu.ops.segments import usable_capacity_bits
from codec_tcc_tpu.parallel import volume as jv
from codec_tcc_tpu_torch import cli as port_cli
from codec_tcc_tpu_torch.config import EncodeConfig
from codec_tcc_tpu_torch.errors import CapacityError
from codec_tcc_tpu_torch.parallel import volume as pv

from torch_parity import same_code, same_code_but_device

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
TEXT = "Mensagem de teste para esteganografia!"
METRIC_RTOL = 1e-4
STRATEGIES = ("multi_plane", "hybrid", "block_adaptive", "pee")
GEOMETRIES = {"u16": (4, 24, 40, np.uint16, 4095),
              "u8odd": (3, 17, 19, np.uint8, 255)}


def _volume(geom: str, seed: int = 5) -> np.ndarray:
    """A smooth body-like gradient with small seeded noise per slice."""
    d, h, w, dtype, hi = GEOMETRIES[geom]
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = hi * (0.3 + 0.4 * x / w + 0.2 * y / h)
    noise = rng.normal(0, hi / 300 + 1, (d, h, w))
    slope = np.linspace(0, hi * 0.05, d)[:, None, None]
    return np.clip(np.rint(base[None] + noise + slope), 0, hi).astype(dtype)


def _pee_caps(vol: np.ndarray) -> np.ndarray:
    """(D, 128) histogram capacities of both passes (the JAX package's)."""
    max_val = (1 << (8 * vol.dtype.itemsize)) - 1
    h0, h1 = jv._cap_hists_jit(vol, 128, max_val)
    return (jax_pee.capacities_by_threshold(np.asarray(h0))
            + jax_pee.capacities_by_threshold(np.asarray(h1)))


def _payload(geom: str, strategy: str, kind: str) -> np.ndarray:
    if kind == "text":
        return np.unpackbits(np.frombuffer(TEXT.encode(), np.uint8))
    vol = _volume(geom)
    d, h, w = vol.shape
    if strategy == "pee":
        # near the histogram split's capacity at T=6 (discount 64 a slice)
        total = int(np.maximum(_pee_caps(vol)[:, 5] - 64, 0).sum())
    else:
        # exactly the volume's LSB capacity
        s, _ = jv.volume_cut_point(vol, 0.4)
        total = usable_capacity_bits(s, h * w, 42) * d
    return np.random.default_rng(7).integers(0, 2, total, dtype=np.uint8)


CASES = [(g, st, k) for g in GEOMETRIES for st in STRATEGIES
         for k in ("text", "capacity")]
IDS = [f"{g}-{st}-{k}" for g, st, k in CASES]
_RUNS: dict = {}


def _run(geom, strategy, kind):
    """(volume, payload, JAX result, JAX STGV, port result, port STGV), one
    run per case for the whole module."""
    key = (geom, strategy, kind)
    if key not in _RUNS:
        vol = _volume(geom)
        bits = _payload(geom, strategy, kind)
        jcfg, pcfg = JaxConfig(strategy=strategy), EncodeConfig(
            strategy=strategy)
        jr = jv.encode_volume(vol, bits, jcfg)
        jblob = jv.pack_volume(vol, jr, jcfg)
        pr = pv.encode_volume(vol, bits, pcfg, device="cpu")
        pblob = pv.pack_volume(vol, pr, pcfg, device="cpu")
        _RUNS[key] = (vol, bits, jr, jblob, pr, pblob)
    return _RUNS[key]


@pytest.mark.parametrize("geom,strategy,kind", CASES, ids=IDS)
def test_stgv_bytes_match_jax(geom, strategy, kind):
    vol, bits, jr, jblob, pr, pblob = _run(geom, strategy, kind)
    assert pblob == jblob
    assert pr.s == jr.s and pr.threshold == jr.threshold
    np.testing.assert_array_equal(pr.slice_bits, jr.slice_bits)
    np.testing.assert_array_equal(pr.stego, jr.stego)
    assert int(pr.slice_bits.sum()) == bits.size
    if kind == "capacity" and strategy != "pee":
        # the whole LSB capacity: every slice full
        assert (pr.slice_bits == pr.slice_bits[0]).all()


@pytest.mark.parametrize("geom,strategy,kind", CASES, ids=IDS)
def test_unpack_volume_is_exact(geom, strategy, kind):
    vol, bits, _, jblob, _, pblob = _run(geom, strategy, kind)
    payload, stego, original = pv.unpack_volume(pblob, device="cpu")
    jpayload, jstego, joriginal = jv.unpack_volume(jblob)
    np.testing.assert_array_equal(payload, bits)
    np.testing.assert_array_equal(original, vol)
    np.testing.assert_array_equal(payload, jpayload)
    np.testing.assert_array_equal(stego, jstego)
    np.testing.assert_array_equal(original, joriginal)


@pytest.mark.parametrize("geom,strategy,kind",
                         [c for c in CASES if c[1] != "pee"],
                         ids=[i for c, i in zip(CASES, IDS) if c[1] != "pee"])
def test_extract_volume_is_exact(geom, strategy, kind):
    _, bits, jr, _, pr, _ = _run(geom, strategy, kind)
    if strategy == "block_adaptive":
        # the raster extract reads raster windows: a block volume reads
        # back through unpack_volume; both packages give the same bits
        np.testing.assert_array_equal(
            pv.extract_volume(pr.stego, pr.plan, device="cpu"),
            jv.extract_volume(jr.stego, jr.plan))
        return
    got = pv.extract_volume(pr.stego, pr.plan, device="cpu")
    np.testing.assert_array_equal(got, bits)
    np.testing.assert_array_equal(got, jv.extract_volume(jr.stego, jr.plan))


@pytest.mark.parametrize("geom,strategy,kind", CASES, ids=IDS)
def test_volume_metrics_match_jax(geom, strategy, kind):
    vol, _, jr, _, pr, _ = _run(geom, strategy, kind)
    got, want = pr.metrics, jr.metrics
    assert got.keys() == want.keys()
    for k in ("changed_pixels", "max_abs_diff", "max_value"):
        assert got[k] == want[k], k
    np.testing.assert_allclose(got["mean_abs_diff"], want["mean_abs_diff"],
                               rtol=METRIC_RTOL)
    np.testing.assert_allclose(got["changed_percent"],
                               want["changed_percent"], rtol=METRIC_RTOL)
    if int(vol.max()) == int(pr.stego.max()):
        for k in ("mse", "psnr", "ssim"):
            np.testing.assert_allclose(got[k], want[k], rtol=METRIC_RTOL,
                                       err_msg=k)


@pytest.mark.parametrize("name", ["vol64_u16_hybrid_text",
                                  "vol64_u16_multi_text"])
def test_full_size_volume_metrics_match_fixture(name):
    """The 64 x 512x512 volumes of ``chip_smoke.py`` whose report the
    fixture holds (``make_torch_port_fixtures.py``): the same limits as the
    small cases, on the equal-range branch."""
    import torch_port_cases as cases

    assert name in cases.VOLUME_METRICS_CASES
    vparity = cases.load_parity_volumes()
    vcase = cases.VOLUMES_BY_NAME[name]
    vol = cases.volume(vcase)
    bits = cases.volume_payload_bits(vcase, vparity[name]["lsb_bits"])
    res = pv.encode_volume(vol, bits, vcase.config(EncodeConfig),
                           device="cpu")
    assert int(res.stego.max()) == int(vol.max())
    got, want = res.metrics, vparity[f"metrics_{name}"]
    assert got.keys() == want.keys()
    for k, v in want.items():
        if k in ("changed_pixels", "max_abs_diff", "max_value"):
            assert got[k] == v, k
        else:
            np.testing.assert_allclose(got[k], v, rtol=METRIC_RTOL,
                                       err_msg=k)


def test_metrics_cases_cover_both_range_branches():
    equal = [int(_run(*c)[0].max()) == int(_run(*c)[4].stego.max())
             for c in CASES]
    assert any(equal) and not all(equal)


@pytest.mark.parametrize("geom", GEOMETRIES)
def test_volume_cut_point_matches_jax(geom):
    vol = _volume(geom)
    s, total = pv.volume_cut_point(vol, 0.4, device="cpu")
    js, jtotal = jv.volume_cut_point(vol, 0.4)
    assert s == js
    np.testing.assert_array_equal(total, np.asarray(jtotal))


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_oversize_payload_raises_jax_message(strategy):
    vol = _volume("u8odd")
    d, h, w = vol.shape
    if strategy == "pee":
        # past the histogram capacity by more than the probe band: no
        # probe runs, the error names the estimate at T=128
        n = int(_pee_caps(vol)[:, -1].sum()) + 1024 * d + 1
    else:
        s, _ = jv.volume_cut_point(vol, 0.4)
        n = usable_capacity_bits(s, h * w, 42) * d + 1
    bits = np.ones(n, np.uint8)
    with pytest.raises(JaxCapacityError) as want:
        jv.encode_volume(vol, bits, JaxConfig(strategy=strategy))
    with pytest.raises(CapacityError) as got:
        pv.encode_volume(vol, bits, EncodeConfig(strategy=strategy),
                         device="cpu")
    assert str(got.value) == str(want.value)


def test_unknown_strategy_raises_jax_message():
    vol = _volume("u8odd")
    cfgs = [cls(strategy="hybrid") for cls in (JaxConfig, EncodeConfig)]
    for cfg in cfgs:
        object.__setattr__(cfg, "strategy", "nope")
    with pytest.raises(ValueError) as want:
        jv.encode_volume(vol, "x", cfgs[0])
    with pytest.raises(ValueError) as got:
        pv.encode_volume(vol, "x", cfgs[1], device="cpu")
    assert str(got.value) == str(want.value)


def test_golden_block_volume_decodes_in_port():
    vol = np.load(os.path.join(DATA, "golden_block_volume.npy"))
    with open(os.path.join(DATA, "golden_block_volume.stgv"), "rb") as f:
        blob = f.read()
    with open(os.path.join(DATA, "golden_payload.bin"), "rb") as f:
        want = np.unpackbits(np.frombuffer(f.read(), np.uint8))[:1200]
    bits, stego, original = pv.unpack_volume(blob, device="cpu")
    np.testing.assert_array_equal(bits, want)
    np.testing.assert_array_equal(original, vol)
    jbits, jstego, _ = jv.unpack_volume(blob)
    np.testing.assert_array_equal(stego, jstego)


def _malformed():
    _, _, _, _, _, blob = _run("u8odd", "hybrid", "text")
    d = struct.unpack_from(">I", blob, 8)[0]
    return {
        "bad_magic": b"XXXX" + blob[4:],
        "short_header": blob[:10],
        "short_sizes": blob[:4 + struct.calcsize(">IIQI") + 1 + 8 * d - 3],
        "bad_strategy": blob[:24] + b"\x7f" + blob[25:],
        "short_body": blob[:-5],
    }


@pytest.mark.parametrize("kind", ["bad_magic", "short_header", "short_sizes",
                                  "bad_strategy", "short_body"])
def test_malformed_stgv_raises_jax_value_error(kind):
    data = _malformed()[kind]
    with pytest.raises(ValueError) as want:
        jv.unpack_volume(data)
    with pytest.raises(ValueError) as got:
        pv.unpack_volume(data, device="cpu")
    assert str(got.value) == str(want.value)
    assert str(got.value).startswith("Invalid file:")


@pytest.mark.parametrize("call", ["encode_volume", "volume_cut_point",
                                  "extract_volume"])
def test_mesh_raises_not_implemented(call):
    """A volume whose depth (3) does not split evenly over the mesh's
    ``dp`` axis (2) raises ``ValueError``, as the JAX package's
    ``device_put`` does: nothing is left unimplemented for a mesh."""
    from codec_tcc_tpu.parallel import mesh as jax_mesh
    from codec_tcc_tpu_torch.parallel.mesh import make_mesh

    vol = _volume("u8odd")
    mesh = make_mesh(devices=["cpu"] * 2, axes=("dp",))
    jmesh = jax_mesh.make_mesh(2, ("dp",))
    for m, dev in ((jmesh, None), (mesh, "cpu")):
        kw = {} if dev is None else {"device": dev}
        mod = jv if dev is None else pv
        cfg = JaxConfig() if dev is None else EncodeConfig()
        with pytest.raises(ValueError):
            if call == "encode_volume":
                mod.encode_volume(vol, "x", cfg, m, **kw)
            elif call == "volume_cut_point":
                mod.volume_cut_point(vol, 0.4, m, **kw)
            else:
                _, _, _, _, pr, _ = _run("u8odd", "hybrid", "text")
                np.asarray(mod.extract_volume(pr.stego, pr.plan, m, **kw))


def test_default_device_is_cuda():
    """Without a card the default device raises instead of running on the
    CPU; the tensors of the CPU tests never reach a kernel."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default runs there")
    vol = _volume("u8odd")
    with pytest.raises(RuntimeError, match="cuda"):
        pv.encode_volume(vol, "x")
    _, _, _, _, _, blob = _run("u8odd", "hybrid", "text")
    with pytest.raises(RuntimeError, match="cuda"):
        pv.unpack_volume(blob)


@pytest.mark.parametrize("name", ["unpack_volume", "extract_volume"])
def test_copies_are_the_jax_code_but_for_device(name):
    assert same_code_but_device(getattr(pv, name), getattr(jv, name),
                                spans=True)


@pytest.mark.parametrize("port_obj,jax_obj", [
    (pv.VolumeResult, jv.VolumeResult),
    (port_cli._load_volume, jax_cli._load_volume),
], ids=["VolumeResult", "_load_volume"])
def test_copies_are_the_jax_code(port_obj, jax_obj):
    assert same_code(port_obj, jax_obj)
    assert pv.VOLUME_MAGIC == jv.VOLUME_MAGIC


def test_attempt_groups_replay_the_escalation_loop():
    """An image that falls short at T joins the same round's group at T + 1:
    seven slices starting at T=60 and one at 59, all fitting at 67 (66),
    take one group per T from 59 to 67, not two per round."""
    import torch_port_cases as cases

    assert cases.pee_attempt_groups([60] * 7 + [59], [67] * 7 + [66]) == 9
    assert cases.pee_attempt_groups([2, 9, 2, 47], [2, 10, 2, 52]) == 9
    assert cases.pee_attempt_groups([5, 5], [5, 5]) == 1


@pytest.mark.parametrize("geom", GEOMETRIES)
def test_pee_volume_kernel_calls_follow_the_attempt_groups(monkeypatch,
                                                           geom):
    """A PEE volume calls the K3 wrapper twice per equal-T attempt group of
    its one batch encode and the K4 wrapper twice per threshold group of
    its decode: the exact launch counts ``chip_smoke.py`` requires."""
    import torch_port_cases as cases
    from codec_tcc_tpu_torch.io.container import parse, parse_pee_ext
    from codec_tcc_tpu_torch.ops import pee_kernels as pk
    from codec_tcc_tpu_torch.parallel import batch_pee

    calls = {"pee_embed": 0, "pee_extract": 0}
    for name in calls:
        def counted(*args, _name=name, _fn=getattr(pk, name)):
            calls[_name] += 1
            return _fn(*args)
        monkeypatch.setattr(pk, name, counted)
    vol = _volume(geom)
    bits = _payload(geom, "pee", "capacity")
    res = pv.encode_volume(vol, bits, EncodeConfig(strategy="pee"),
                           device="cpu")
    encoded = calls["pee_embed"]
    blob = pv.pack_volume(vol, res, EncodeConfig(strategy="pee"),
                          device="cpu")
    pv.unpack_volume(blob, device="cpu")
    t_final = [parse_pee_ext(parse(c).meta.ext)[0] for c in res.containers]
    t_start = batch_pee._start_thresholds(
        torch.from_numpy(vol), np.asarray(res.slice_bits),
        (1 << (8 * vol.dtype.itemsize)) - 1, 2)
    assert encoded == 2 * cases.pee_attempt_groups(t_start, t_final)
    assert calls["pee_extract"] == 2 * len(set(t_final))
