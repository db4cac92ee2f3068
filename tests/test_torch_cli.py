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
