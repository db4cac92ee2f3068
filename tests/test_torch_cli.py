"""``python -m codec_tcc_tpu_torch encode|decode --device cpu`` on a DICOM
that the port's own writer made, with the default strategy, with
``--strategy pee``, with ``--strategy block_adaptive`` and with
``--device-policy host``: the message and the restored original come back
exact. The batch, volume, capacity, analyze and demo commands run in this
process beside the JAX package's CLI on the same files: the same exit
codes, output lines (numbers from float32 moments within rtol 1e-4) and
files."""

import os
import subprocess
import sys

import numpy as np
import pytest

from codec_tcc_tpu_torch import cli
from codec_tcc_tpu_torch.io import dicom

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESSAGE = "Mensagem de teste para esteganografia!"


def _run(args, cwd):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (REPO, env.get("PYTHONPATH")) if p)
    return subprocess.run(
        [sys.executable, "-m", "codec_tcc_tpu_torch", *args], cwd=cwd,
        env=env, capture_output=True, text=True, timeout=300,
    )


@pytest.fixture
def dicom_input(tmp_path):
    rng = np.random.default_rng(8)
    y, x = np.mgrid[0:48, 0:64]
    img = np.clip(x * 40 + y * 20 + rng.normal(0, 60, (48, 64)), 0, 4095)
    img = img.astype(np.uint16)
    path = tmp_path / "in.dcm"
    dicom.save_image(img, str(path), bits_stored=12)
    return img, path


def test_cli_encode_decode_roundtrip_on_cpu(tmp_path, dicom_input):
    img, path = dicom_input
    enc = _run(["encode", str(path), "out.stgc", "--message", MESSAGE,
                "--device", "cpu",
                "--report", "enc.json"], tmp_path)
    assert enc.returncode == 0, enc.stderr
    assert "cut point s" in enc.stdout
    dec = _run(["decode", "out.stgc", "--output-prefix", "dec",
                "--device", "cpu"], tmp_path)
    assert dec.returncode == 0, dec.stderr
    assert (tmp_path / "dec_message.txt").read_text(encoding="utf-8") == MESSAGE
    original, _ = dicom.load_image(str(tmp_path / "dec_original.dcm"))
    np.testing.assert_array_equal(original, img)
    stego, _ = dicom.load_image(str(tmp_path / "dec_stego.dcm"))
    assert stego.shape == img.shape and stego.dtype == img.dtype


def test_cli_pee_roundtrip_on_cpu(tmp_path, dicom_input):
    img, path = dicom_input
    enc = _run(["encode", str(path), "out.stgc", "--message", MESSAGE,
                "--strategy", "pee", "--device", "cpu"], tmp_path)
    assert enc.returncode == 0, enc.stderr
    assert "strategy             : pee" in enc.stdout
    dec = _run(["decode", "out.stgc", "--output-prefix", "dec",
                "--device", "cpu"], tmp_path)
    assert dec.returncode == 0, dec.stderr
    assert (tmp_path / "dec_message.txt").read_text(encoding="utf-8") == MESSAGE
    original, _ = dicom.load_image(str(tmp_path / "dec_original.dcm"))
    np.testing.assert_array_equal(original, img)


@pytest.mark.parametrize("extra,stored", [
    (["--strategy", "block_adaptive", "--block-size", "12"], "block_adaptive"),
    (["--device-policy", "host"], "hybrid"),
], ids=["block_adaptive", "device_policy_host"])
def test_cli_block_and_host_route_roundtrip_on_cpu(tmp_path, dicom_input,
                                                   extra, stored):
    img, path = dicom_input
    enc = _run(["encode", str(path), "out.stgc", "--message", MESSAGE,
                *extra, "--device", "cpu"], tmp_path)
    assert enc.returncode == 0, enc.stderr
    assert f"strategy             : {stored}" in enc.stdout
    dec = _run(["decode", "out.stgc", "--output-prefix", "dec",
                "--device", "cpu"], tmp_path)
    assert dec.returncode == 0, dec.stderr
    assert (tmp_path / "dec_message.txt").read_text(encoding="utf-8") == MESSAGE
    original, _ = dicom.load_image(str(tmp_path / "dec_original.dcm"))
    np.testing.assert_array_equal(original, img)


def test_cli_reports_unported_request(tmp_path, dicom_input, capsys):
    _, path = dicom_input
    rc = cli.main(["encode", str(path), str(tmp_path / "o.stgc"),
                   "--message", "x", "--codec", "png", "--device", "cpu"])
    assert rc == 1 and "not yet ported" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# encode-batch / decode-batch against the JAX package's CLI
# ---------------------------------------------------------------------------


def _batch_files(tmp_path):
    """Two .npy uint16 images of one geometry, a third of another, and a
    DICOM (BitsStored 12): three batch groups."""
    rng = np.random.default_rng(9)

    def smooth(shape):
        y, x = np.mgrid[0:shape[0], 0:shape[1]]
        img = x * 30 + y * 20 + rng.normal(0, 4, shape) + 500
        return np.clip(img, 0, 4095).astype(np.uint16)

    paths = []
    for name, shape in (("n1", (40, 48)), ("n2", (40, 48)), ("n3", (24, 32))):
        np.save(tmp_path / f"{name}.npy", smooth(shape))
        paths.append(str(tmp_path / f"{name}.npy"))
    dicom.save_image(smooth((32, 40)), str(tmp_path / "d1.dcm"),
                     bits_stored=12)
    paths.append(str(tmp_path / "d1.dcm"))
    return paths


def _both_clis(args_jax, args_port, capsys):
    """Run the JAX CLI and the port's in this process; return their exit
    codes and outputs."""
    from codec_tcc_tpu.cli import main as jax_main

    out = []
    for main, args in ((jax_main, args_jax), (cli.main, args_port)):
        rc = main(args)
        cap = capsys.readouterr()
        out.append((rc, cap.out, cap.err))
    return out


@pytest.mark.parametrize("strategy", ["hybrid", "pee"])
def test_cli_batch_fused_and_decode_batch_match_jax(tmp_path, capsys,
                                                    strategy):
    paths = _batch_files(tmp_path)
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    common = ["encode-batch", *paths, "--message", MESSAGE, "--fused",
              "--strategy", strategy]
    (jrc, jout, _), (prc, pout, _) = _both_clis(
        common + ["--output-dir", str(jdir)],
        common + ["--output-dir", str(pdir), "--device", "cpu"], capsys)
    assert jrc == prc == 0
    assert pout.replace(str(pdir), "D") == jout.replace(str(jdir), "D")
    conts = sorted(p.name for p in jdir.glob("*.stgc"))
    assert conts == sorted(p.name for p in pdir.glob("*.stgc"))
    assert len(conts) == len(paths)
    for name in conts:
        assert (pdir / name).read_bytes() == (jdir / name).read_bytes()

    jdec, pdec = tmp_path / "jdec", tmp_path / "pdec"
    (jrc, jout, _), (prc, pout, _) = _both_clis(
        ["decode-batch", *[str(jdir / c) for c in conts],
         "--output-dir", str(jdec)],
        ["decode-batch", *[str(pdir / c) for c in conts],
         "--output-dir", str(pdec), "--device", "cpu"], capsys)
    assert jrc == prc == 0
    assert pout.replace(str(pdec), "D") == jout.replace(str(jdec), "D")
    for name in sorted(os.listdir(jdec)):
        got, want = pdec / name, jdec / name
        if name.endswith(".dcm"):
            np.testing.assert_array_equal(dicom.load_image(str(got))[0],
                                          dicom.load_image(str(want))[0])
        else:
            assert got.read_bytes() == want.read_bytes()
    assert (pdec / "n1_message.txt").read_text(encoding="utf-8") == MESSAGE
    original, _ = dicom.load_image(str(pdec / "n3_original.dcm"))
    np.testing.assert_array_equal(original, np.load(paths[2]))


def test_cli_batch_runner_matches_jax(tmp_path, capsys):
    """The per-item runner: the DICOM encodes, the .npy inputs fail in both
    (the runner reads non-DICOM files through PIL, as the JAX package
    does), exit code 1, the same table and ``failed:`` lines, the same
    containers and manifest rows."""
    import json

    paths = _batch_files(tmp_path)
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    common = ["encode-batch", *paths, "--message", MESSAGE]
    (jrc, jout, jerr), (prc, pout, perr) = _both_clis(
        common + ["--output-dir", str(jdir)],
        common + ["--output-dir", str(pdir), "--device", "cpu"], capsys)
    assert jrc == prc == 1
    assert pout.replace(str(pdir), "D") == jout.replace(str(jdir), "D")
    failed = [[ln for ln in err.splitlines() if ln.startswith("failed:")]
              for err in (perr, jerr)]
    assert failed[0] == failed[1] and len(failed[0]) == 3
    assert (pdir / "d1.stgc").read_bytes() == (jdir / "d1.stgc").read_bytes()

    def rows(d):
        with open(d / "manifest.json") as f:
            items = json.load(f)["items"]
        for row in items:
            row.pop("elapsed_s")
            row["output"] = os.path.basename(row["output"])
        return items

    assert rows(pdir) == rows(jdir)


# ---------------------------------------------------------------------------
# encode-volume / decode-volume / capacity / analyze / analyze-batch / demo
# ---------------------------------------------------------------------------


def _volume_file(tmp_path, dtype=np.uint16, shape=(3, 24, 40)):
    rng = np.random.default_rng(11)
    hi = 4095 if dtype == np.uint16 else 255
    y, x = np.mgrid[0:shape[1], 0:shape[2]]
    vol = hi * (0.3 + 0.4 * x / shape[2]) + rng.normal(0, 3, shape)
    vol = np.clip(np.rint(vol), 0, hi).astype(dtype)
    np.save(tmp_path / "vol.npy", vol)
    return vol, str(tmp_path / "vol.npy")


@pytest.mark.parametrize("strategy,dtype", [
    ("multi_plane", np.uint16), ("hybrid", np.uint8), ("pee", np.uint16),
    ("block_adaptive", np.uint16)])
def test_cli_volume_matches_jax(tmp_path, capsys, strategy, dtype):
    shape = (3, 17, 19) if dtype == np.uint8 else (3, 24, 40)
    vol, path = _volume_file(tmp_path, dtype, shape)
    common = ["encode-volume", path, "--message", MESSAGE, "--strategy",
              strategy]
    (jrc, jout, _), (prc, pout, _) = _both_clis(
        common + ["--output", str(tmp_path / "j.stgv")],
        common + ["--output", str(tmp_path / "p.stgv"), "--device", "cpu",
                  "--report", str(tmp_path / "p.json")], capsys)
    assert jrc == prc == 0
    assert pout == jout
    assert ((tmp_path / "p.stgv").read_bytes()
            == (tmp_path / "j.stgv").read_bytes())
    (jrc, jout, _), (prc, pout, _) = _both_clis(
        ["decode-volume", str(tmp_path / "j.stgv"), "--output-prefix",
         str(tmp_path / "jd"), "--dicom"],
        ["decode-volume", str(tmp_path / "p.stgv"), "--output-prefix",
         str(tmp_path / "pd"), "--dicom", "--device", "cpu"], capsys)
    assert jrc == prc == 0
    assert pout.replace("pd", "X") == jout.replace("jd", "X")
    for suffix in ("_payload.bin", "_stego.npy", "_original.npy"):
        assert ((tmp_path / f"pd{suffix}").read_bytes()
                == (tmp_path / f"jd{suffix}").read_bytes())
    assert (tmp_path / "pd_payload.bin").read_bytes() == MESSAGE.encode()
    np.testing.assert_array_equal(np.load(tmp_path / "pd_original.npy"), vol)
    restored, _ = dicom.load_image(str(tmp_path / "pd_original.dcm"))
    np.testing.assert_array_equal(restored, vol)


@pytest.mark.parametrize("what", ["dicom", "volume"])
def test_cli_capacity_matches_jax(tmp_path, capsys, dicom_input, what):
    import json

    path = (str(dicom_input[1]) if what == "dicom"
            else _volume_file(tmp_path)[1])
    for extra in ([], ["--json"], ["--pee-threshold", "4", "--nbits", "6"]):
        (jrc, jout, _), (prc, pout, _) = _both_clis(
            ["capacity", path, *extra],
            ["capacity", path, *extra, "--device", "cpu"], capsys)
        assert jrc == prc == 0
        assert pout == jout
        if extra == ["--json"]:
            assert json.loads(pout)["input"] == path


def _numbers_match(got: str, want: str):
    """Equal lines, but numbers within rtol 1e-4 (float32 moments)."""
    import re

    num = re.compile(r"-?\d+(?:\.\d+)?")
    gl, wl = got.splitlines(), want.splitlines()
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        assert num.sub("#", g) == num.sub("#", w), (g, w)
        np.testing.assert_allclose(
            [float(v) for v in num.findall(g)],
            [float(v) for v in num.findall(w)], rtol=1e-4, atol=1.5e-6,
            err_msg=g)


@pytest.mark.parametrize("extra", [[], ["--windowed-ssim"],
                                   ["--bits-stored-range", "--windowed-ssim"]],
                         ids=["data", "windowed", "bits_stored_range"])
def test_cli_analyze_matches_jax(tmp_path, capsys, dicom_input, extra):
    img, path = dicom_input
    stego = img ^ np.uint16(1)
    dicom.save_image(stego, str(tmp_path / "s.dcm"), bits_stored=16)
    args = ["analyze", str(path), str(tmp_path / "s.dcm"), *extra]
    (jrc, jout, _), (prc, pout, _) = _both_clis(
        args, args + ["--device", "cpu"], capsys)
    assert jrc == prc == 0
    if "--bits-stored-range" in extra:
        # 12 against 16 bits stored: the float64 host branch, exact
        assert pout == jout
    else:
        _numbers_match(pout, jout)


def test_cli_analyze_report_matches_fixture(tmp_path, capsys):
    """``analyze --windowed-ssim --report`` on the pair ``chip_smoke.py``
    runs, against the JAX CLI's report in the fixture: windowed SSIM within
    rtol 1e-5 and atol 1e-6, the rest within rtol 1e-4."""
    import json

    import torch_port_cases as cases

    orig, stego = cases.cli_analyze_pair(dicom.save_image, str(tmp_path))
    report = tmp_path / "r.json"
    assert cli.main(["analyze", orig, stego, "--windowed-ssim", "--report",
                     str(report), "--device", "cpu"]) == 0
    capsys.readouterr()
    got = json.loads(report.read_text(encoding="utf-8"))
    want = cases.load_parity_volumes()[cases.CLI_ANALYZE_CASE]["report"]
    assert got.keys() == want.keys()
    assert got.pop("command") == want.pop("command") == "analyze"
    np.testing.assert_allclose(got.pop("ssim_windowed"),
                               want.pop("ssim_windowed"), rtol=1e-5,
                               atol=1e-6)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-4, err_msg=k)


def test_cli_analyze_batch_matches_jax(tmp_path, capsys, dicom_input):
    import json

    img, path = dicom_input
    pairs = []
    for i, flip in enumerate((1, 3)):
        p = str(tmp_path / f"s{i}.dcm")
        dicom.save_image(img ^ np.uint16(flip), p, bits_stored=12)
        pairs += [str(path), p]
    args = ["analyze-batch", *pairs, "--windowed-ssim"]
    (jrc, jout, _), (prc, pout, _) = _both_clis(
        args + ["--report", str(tmp_path / "j.json")],
        args + ["--report", str(tmp_path / "p.json"), "--device", "cpu"],
        capsys)
    assert jrc == prc == 0
    _numbers_match(pout, jout)
    with open(tmp_path / "p.json") as f:
        rep = json.load(f)
    assert len(rep["pairs"]) == 2 and rep["summary"]["count"] == 2.0
    (jrc, _, jerr), (prc, _, perr) = _both_clis(
        ["analyze-batch", str(path)], ["analyze-batch", str(path)], capsys)
    assert jrc == prc == 2 and perr == jerr


def test_cli_demo_matches_jax(tmp_path, capsys, dicom_input):
    _, path = dicom_input
    (jrc, jout, _), (prc, pout, _) = _both_clis(
        ["demo", "--input", str(path), "--output-dir", str(tmp_path / "j")],
        ["demo", "--input", str(path), "--output-dir", str(tmp_path / "p"),
         "--device", "cpu"], capsys)
    assert jrc == prc == 0
    assert pout.replace(str(tmp_path / "p"), "D") == jout.replace(
        str(tmp_path / "j"), "D")
    assert "original restored    : OK" in pout
    assert ((tmp_path / "p" / "example.stgc").read_bytes()
            == (tmp_path / "j" / "example.stgc").read_bytes())
