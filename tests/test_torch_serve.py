"""The port's serving daemon (``codec_tcc_tpu_torch.serve``): a real daemon
subprocess, ``python -m codec_tcc_tpu_torch serve --device cpu``, driven
through the Unix-socket JSON-lines protocol of the JAX package's daemon
(the protocol tests of ``tests/test_serve.py``). Every container the daemon
writes equals the JAX package's ``pipeline.encode_file`` (or its volume and
batch entry points) on the same file, run in this process; its decodes,
capacity and analyze answers equal the JAX package's. The daemon's
functions are held to the JAX originals (``tests/torch_parity.py``), all
but ``_op_ping``, which reports the daemon's torch device.

A daemon of these tests is always started with ``--device cpu``.
Tolerances: ``analyze`` reports floats of float32 moments summed in
another order than XLA's; they agree within rtol 1e-4, counts exactly.
"""

import base64
import os
import signal
import socket as socket_mod
import subprocess
import sys
import tempfile
import time

import numpy as np
import pytest

from codec_tcc_tpu import pipeline as jax_pipeline
from codec_tcc_tpu import serve as jax_serve
from codec_tcc_tpu.config import EncodeConfig as JaxConfig
from codec_tcc_tpu.io import dicom as jax_dicom
from codec_tcc_tpu.parallel import volume as jax_volume
from codec_tcc_tpu_torch import serve as port_serve
from codec_tcc_tpu_torch.serve import request

from torch_native import build_native_once
from torch_parity import same_code, same_code_but_clock, same_code_but_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-4


def _start(sock: str, cwd: str, *extra) -> subprocess.Popen:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (REPO, env.get("PYTHONPATH")) if p)
    return subprocess.Popen(
        [sys.executable, "-m", "codec_tcc_tpu_torch", "serve", "--socket",
         sock, "--device", "cpu", *extra],
        env=env, cwd=cwd,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )


@pytest.fixture(scope="module")
def daemon():
    build_native_once(with_jax=True)
    work = tempfile.mkdtemp(prefix="ct_")
    sock = os.path.join(work, "ct.sock")
    proc = _start(sock, work, "--conn-timeout", "5")
    try:
        deadline = time.monotonic() + 120
        last = None
        while time.monotonic() < deadline:
            if proc.poll() is not None:
                out, err = proc.communicate()
                raise RuntimeError(f"daemon died:\n{out}\n{err[-2000:]}")
            try:
                r = request(sock, {"op": "ping"}, timeout=10)
                assert r["ok"]
                break
            except (OSError, ConnectionError) as exc:
                last = exc
                time.sleep(0.3)
        else:
            raise RuntimeError(f"daemon never came up: {last}")
        yield {"sock": sock, "work": work, "proc": proc}
        r = request(sock, {"op": "shutdown"}, timeout=30)
        assert r["ok"]
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)


def _dcm(work: str, name: str, arr: np.ndarray, bits_stored=None) -> str:
    path = os.path.join(work, name)
    jax_dicom.save_image(arr, path, bits_stored=bits_stored)
    return path


def _image(seed, h=64, w=64, hi=4096):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = hi * (0.2 + 0.5 * x / w + 0.2 * y / h)
    return np.clip(base + rng.normal(0, hi / 100, (h, w)), 0,
                   hi - 1).astype(np.uint16)


def _read(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


# ---------------------------------------------------------------------------
# the daemon's code against the JAX package's
# ---------------------------------------------------------------------------


_SAME = ("_parse_config", "_parse_payload", "_handle_line", "request")
# the handler takes a reply's wall_ms from its profiling request span
_BUT_CLOCK = ("_handle_line",)
_BUT_DEVICE = ("_op_encode", "_op_decode", "_op_encode_batch",
               "_op_decode_batch", "_op_encode_volume", "_op_decode_volume",
               "_op_capacity", "_op_analyze", "_warmup", "serve")


@pytest.mark.parametrize("name", _SAME + _BUT_DEVICE)
def test_daemon_functions_are_the_jax_code(name):
    check = (same_code_but_clock if name in _BUT_CLOCK
             else same_code if name in _SAME else same_code_but_device)
    assert check(getattr(port_serve, name), getattr(jax_serve, name))
    assert sorted(port_serve._OPS) == sorted(jax_serve._OPS)


# ---------------------------------------------------------------------------
# the protocol (tests/test_serve.py), against the JAX package's answers
# ---------------------------------------------------------------------------


def test_ping_reports_backend(daemon):
    r = request(daemon["sock"], {"op": "ping"})
    assert r["ok"] and r["op"] == "ping"
    assert r["backend"] == "cpu" and r["device_count"] == 1
    assert r["pid"] == daemon["proc"].pid
    assert isinstance(r["ops_served"], dict)
    assert r["requests_served"] == sum(r["ops_served"].values())
    assert set(r) == {"backend", "device_count", "uptime_s",
                      "requests_served", "ops_served", "pid", "ok", "op",
                      "wall_ms"}


@pytest.mark.parametrize("config", [
    {"strategy": "hybrid", "codec": "deflate"},
    {"strategy": "pee", "codec": "deflate"},
    {"strategy": "hybrid", "codec": "jls"},
    {"strategy": "block_adaptive", "codec": "jls"},
    {"strategy": "multi_plane", "codec": "jls", "container_version": 1},
], ids=["hybrid", "pee", "jls", "block_jls", "v1_jls"])
def test_encode_decode_roundtrip(daemon, config):
    work, sock = daemon["work"], daemon["sock"]
    img = _image(10)
    tag = "_".join(f"{v}" for v in config.values())
    src = _dcm(work, f"in_{tag}.dcm", img, bits_stored=12)
    out = os.path.join(work, f"out_{tag}.stgc")
    r = request(sock, {"op": "encode", "input": src, "output": out,
                       "message": "warm serving round trip",
                       "config": config})
    assert r["ok"], r
    want = jax_pipeline.encode_file(src, "warm serving round trip",
                                    JaxConfig(**config))
    assert _read(out) == want.container
    assert r["container_bytes"] == len(want.container)
    assert r["codec"] == config["codec"]
    assert r["s"] == want.s and r["payload_bits"] == want.meta.payload_bits
    assert r["metrics"]["changed_pixels"] == want.metrics["changed_pixels"]
    assert r["metrics"]["psnr"] == pytest.approx(want.metrics["psnr"],
                                                 rel=RTOL)
    assert r["wall_ms"] > 0

    prefix = os.path.join(work, f"dec_{tag}")
    d = request(sock, {"op": "decode", "input": out, "output_prefix": prefix})
    assert d["ok"], d
    with open(d["payload_path"], encoding="utf-8") as f:
        assert f.read() == "warm serving round trip"
    restored, _ = jax_dicom.load_image(d["original_path"])
    np.testing.assert_array_equal(restored, img)
    stego, _ = jax_dicom.load_image(d["stego_path"])
    np.testing.assert_array_equal(stego, want.stego)

    d2 = request(sock, {"op": "decode", "input": out})
    assert d2["ok"] and base64.b64decode(d2["payload_b64"]) == \
        b"warm serving round trip"


def test_binary_payload_encodes_as_in_jax(daemon):
    work, sock = daemon["work"], daemon["sock"]
    src = _dcm(work, "bin.dcm", _image(13), bits_stored=12)
    payload = bytes(range(40))
    out = os.path.join(work, "bin.stgc")
    r = request(sock, {"op": "encode", "input": src, "output": out,
                       "payload_b64": base64.b64encode(payload).decode()})
    assert r["ok"], r
    assert _read(out) == jax_pipeline.encode_file(src, payload).container
    d = request(sock, {"op": "decode", "input": out})
    assert base64.b64decode(d["payload_b64"]) == payload


def test_analyze_pair(daemon):
    work, sock = daemon["work"], daemon["sock"]
    a = _image(11, 32, 32)
    b = a.copy()
    b[0, 0] ^= 1
    r = request(sock, {"op": "analyze",
                       "original": _dcm(work, "a.dcm", a),
                       "stego": _dcm(work, "b.dcm", b)})
    assert r["ok"], r
    assert r["changed_pixels"] == 1 and "verdict" in r
    want = jax_pipeline.analyze_pair(a, b)
    for k, v in want.items():
        if isinstance(v, float):
            assert r[k] == pytest.approx(v, rel=RTOL, abs=1e-12), k
        else:
            assert r[k] == v, k


@pytest.mark.parametrize("config", [
    {"strategy": "multi_plane", "codec": "deflate"},
    {"strategy": "hybrid", "codec": "jls"},
], ids=["multi_plane", "jls"])
def test_volume_roundtrip_over_daemon(daemon, config):
    work, sock = daemon["work"], daemon["sock"]
    vol = np.stack([_image(12 + k, 32, 32) for k in range(3)])
    src = os.path.join(work, f"vol_{config['codec']}.npy")
    np.save(src, vol)
    out = os.path.join(work, f"vol_{config['codec']}.stgv")
    r = request(sock, {"op": "encode_volume", "inputs": [src], "output": out,
                       "message": "volume over the daemon",
                       "config": config})
    assert r["ok"], r
    cfg = JaxConfig(**config)
    res = jax_volume.encode_volume(vol, "volume over the daemon", cfg)
    assert _read(out) == jax_volume.pack_volume(vol, res, cfg)
    assert r["slices"] == 3 and r["s"] == res.s

    prefix = os.path.join(work, f"vdec_{config['codec']}")
    d = request(sock, {"op": "decode_volume", "input": out,
                       "output_prefix": prefix, "dicom": True})
    assert d["ok"], d
    with open(d["payload_path"], "rb") as f:
        assert f.read() == b"volume over the daemon"
    np.testing.assert_array_equal(np.load(d["original_path"]), vol)
    frames, _ = jax_dicom.load_image(d["stego_dicom"])
    np.testing.assert_array_equal(frames, np.load(d["stego_path"]))


def test_capacity_over_daemon(daemon):
    work, sock = daemon["work"], daemon["sock"]
    y, x = np.mgrid[0:32, 0:32]
    arr = (60 * y + 40 * x).astype(np.uint16)
    path = _dcm(work, "cap.dcm", arr)
    r = request(sock, {"op": "capacity", "input": path, "pee_threshold": 3})
    assert r["ok"], r
    loaded, ds = jax_dicom.load_image(path)
    want = jax_pipeline.capacity_report(loaded, bits_stored=ds.bits_stored,
                                        pee_threshold=3)
    for k, v in want.items():
        assert r[k] == v, k
    assert r["pee_bits"] > 0 and r["input"] == path


def test_silent_connection_does_not_wedge_daemon(daemon):
    """A client that connects and never sends is dropped after
    --conn-timeout (5 s here) so the next client gets served."""
    hostage = socket_mod.socket(socket_mod.AF_UNIX, socket_mod.SOCK_STREAM)
    hostage.connect(daemon["sock"])
    try:
        time.sleep(0.2)
        t0 = time.monotonic()
        r = request(daemon["sock"], {"op": "ping"}, timeout=60)
        assert r["ok"]
        assert time.monotonic() - t0 < 30
    finally:
        hostage.close()


def test_second_daemon_refuses_live_socket(daemon):
    with pytest.raises(RuntimeError, match="already serving"):
        port_serve.serve(daemon["sock"], device="cpu")
    assert request(daemon["sock"], {"op": "ping"})["ok"]


def test_sigterm_exits_cleanly():
    work = tempfile.mkdtemp(prefix="ct_")
    sock = os.path.join(work, "term.sock")
    proc = _start(sock, work)
    try:
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline and not os.path.exists(sock):
            if proc.poll() is not None:
                out, err = proc.communicate()
                raise RuntimeError(f"daemon died:\n{out}\n{err[-2000:]}")
            time.sleep(0.2)
        assert os.path.exists(sock)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
        assert not os.path.exists(sock)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)


def test_errors_do_not_kill_daemon(daemon):
    sock = daemon["sock"]
    r = request(sock, {"op": "transmogrify"})
    assert not r["ok"] and "unknown op" in r["error"]
    r = request(sock, {"op": "encode", "input": "/nope.dcm",
                       "output": "/tmp/x", "message": "m"})
    assert not r["ok"] and r["error_type"] in ("FileNotFoundError",
                                               "ValueError")
    r = request(sock, {"op": "encode", "input": "/nope.dcm",
                       "output": "/tmp/x", "message": "m",
                       "payload_b64": "bQ=="})
    assert not r["ok"] and "exactly one" in r["error"]
    r = request(sock, {"op": "encode", "input": "/nope.dcm",
                       "output": "/tmp/x", "message": "m",
                       "config": {"bogus_knob": 1}})
    assert not r["ok"] and "bogus_knob" in r["error"]
    r = request(sock, {"op": "decode_batch", "inputs": [], "output_dir": "d"})
    assert not r["ok"] and "non-empty list" in r["error"]
    assert request(sock, {"op": "ping"})["ok"]


def test_error_answers_equal_the_jax_daemons():
    """The same bad lines through both packages' request handler give the
    same answer (the daemon's state is not touched by a failure)."""
    lines = [b"not json", b"[1, 2]", b'{"op": "transmogrify"}',
             b'{"op": "encode", "input": "x", "output": "y"}',
             b'{"op": "encode", "message": "m", "config": {"beta": 7}}',
             b'{"op": "encode", "message": "m", "config": []}']
    for line in lines:
        states = [{"t0": 0.0, "served": 0, "op_counts": {}, "device": "cpu"},
                  {"t0": 0.0, "served": 0, "op_counts": {}}]
        got = port_serve._handle_line(line, states[0])
        want = jax_serve._handle_line(line, states[1])
        assert got == want, line
        assert states[0]["served"] == states[1]["served"] == 0


def test_fused_batch_over_daemon(daemon):
    work, sock = daemon["work"], daemon["sock"]
    paths = [_dcm(work, f"b{i}.dcm", _image(20 + i), bits_stored=12)
             for i in range(3)]
    paths.append(_dcm(work, "odd.dcm", _image(30, 32, 48), bits_stored=12))
    enc_dir = os.path.join(work, "enc")
    config = {"compute_metrics": False}
    r = request(sock, {"op": "encode_batch", "inputs": paths,
                       "output_dir": enc_dir, "message": "batched",
                       "config": config})
    assert r["ok"], r
    assert r["fused"] and len(r["items"]) == 4
    assert [it["input"] for it in r["items"]] == paths
    for it in r["items"]:
        want = jax_pipeline.encode_file(it["input"], "batched",
                                        JaxConfig(**config))
        assert _read(it["output"]) == want.container
        assert it["container_bytes"] == len(want.container)

    dec_dir = os.path.join(work, "dec_batch")
    d = request(sock, {"op": "decode_batch",
                       "inputs": [it["output"] for it in r["items"]],
                       "output_dir": dec_dir})
    assert d["ok"], d
    for it, path in zip(d["items"], paths):
        with open(it["payload_path"], encoding="utf-8") as f:
            assert f.read() == "batched"
        restored, _ = jax_dicom.load_image(it["original_path"])
        np.testing.assert_array_equal(restored,
                                      jax_dicom.load_image(path)[0])


def test_in_thread_daemon_with_warmup_on_cpu():
    """Embedded mode, as ``chip_smoke.py`` drives it on the card: serve()
    in a thread of this process (no SIGTERM handler there), with a warm-up
    geometry, then a request and ``shutdown``."""
    import threading

    work = tempfile.mkdtemp(prefix="ct_")
    sock = os.path.join(work, "th.sock")
    rc = []
    thread = threading.Thread(
        target=lambda: rc.append(port_serve.serve(
            sock, warmup="16x24", idle_timeout=60, device="cpu")),
        daemon=True)
    thread.start()
    deadline = time.monotonic() + 60
    while not os.path.exists(sock) and time.monotonic() < deadline:
        time.sleep(0.05)
    r = request(sock, {"op": "ping"})
    assert r["ok"] and r["backend"] == "cpu" and r["pid"] == os.getpid()
    assert request(sock, {"op": "shutdown"})["ok"]
    thread.join(timeout=30)
    assert rc == [0] and not os.path.exists(sock)
