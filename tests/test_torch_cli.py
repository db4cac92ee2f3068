"""``python -m codec_tcc_tpu_torch encode|decode --device cpu`` on a DICOM
that the port's own writer made, with the default strategy, with
``--strategy pee``, with ``--strategy block_adaptive`` and with
``--device-policy host``: the message and the restored original come back
exact."""

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
