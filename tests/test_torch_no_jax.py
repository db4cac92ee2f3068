"""The port runs where jax does not exist: in a fresh interpreter that
cannot import jax, ``codec_tcc_tpu_torch`` imports, encodes and decodes on
the CPU (raster, block_adaptive, the host embed route and PEE, single
image and batch, the container batch path, the runner, volumes, capacity,
analyze, the embedder models, the CLI and one image tiled across a mesh
of CPU devices, raster and PEE; a batch and a volume split over a mesh's
``dp`` axis, ``initialize_distributed`` and the codec stages of
``ops/callback_codec.py``; the ``jls`` codec and v1 containers,
``doctor`` and the ``serve`` daemon), and nothing of the JAX package
gets loaded. Neither the port's sources nor ``chip_smoke.py`` import
jax or the JAX package."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import sys
sys.modules["jax"] = None          # any `import jax` now raises ImportError
import numpy as np
import torch
torch.set_num_threads(1)
import codec_tcc_tpu_torch as port

img = (np.arange(48 * 40, dtype=np.uint16).reshape(48, 40) * 7) % 4096
res = port.encode_array(img, "no jax here", bits_stored=12, device="cpu")
dec = port.decode_container(res.container, device="cpu")
assert dec.message == "no jax here", dec.message
assert np.array_equal(dec.original, img)
pee = port.EncodeConfig(strategy="pee")
res = port.encode_array(img, "pee, no jax", pee, bits_stored=12, device="cpu")
dec = port.decode_container(res.container, device="cpu")
assert dec.message == "pee, no jax", dec.message
assert np.array_equal(dec.original, img)
for cfg in (port.EncodeConfig(strategy="block_adaptive"),
            port.EncodeConfig(compute_metrics=False)):
    res = port.encode_array(img, "block, host", cfg, bits_stored=12,
                            device="cpu")
    dec = port.decode_container(res.container, device="cpu")
    assert dec.message == "block, host", dec.message
    assert np.array_equal(dec.original, img)
from codec_tcc_tpu_torch.parallel import batch_pee
batch = batch_pee.encode_pee_batch(np.stack([img, img]), ["a", "bc"], pee,
                                   bits_stored=12, device="cpu")
decs = batch_pee.decode_pee_batch(batch.containers, device="cpu")
assert [d.message for d in decs] == ["a", "bc"]
from codec_tcc_tpu_torch import cli
from codec_tcc_tpu_torch.parallel import batch, runner
for cfg in (port.EncodeConfig(), port.EncodeConfig(strategy="pee")):
    res = batch.encode_batch_containers(np.stack([img, img[::-1]]),
                                        ["b1", "b22"], cfg, bits_stored=12,
                                        device="cpu")
    decs = batch.decode_batch_containers(res.containers, device="cpu")
    assert [d.message for d in decs] == ["b1", "b22"]
    assert np.array_equal(decs[1].original, img[::-1])
assert runner.BatchRunner and cli.cmd_encode_batch and cli.cmd_decode_batch
from codec_tcc_tpu_torch.parallel import volume
vol = np.stack([img, img[::-1], img[:, ::-1]])
for cfg in (port.EncodeConfig(strategy="multi_plane"), pee):
    res = volume.encode_volume(vol, "a volume", cfg, device="cpu")
    blob = volume.pack_volume(vol, res, cfg, device="cpu")
    bits, _, original = volume.unpack_volume(blob, device="cpu")
    assert bytes(np.packbits(bits)) == b"a volume"
    assert np.array_equal(original, vol)
    if res.plan is not None:
        bits = volume.extract_volume(res.stego, res.plan, device="cpu")
        assert bytes(np.packbits(bits)) == b"a volume"
from codec_tcc_tpu_torch import pipeline
for arr in (img, vol):
    rep = pipeline.capacity_report(arr, bits_stored=12, device="cpu")
    assert rep["lsb_bits"] > 0 and rep["pee_bits"] > 0
rep = port.analyze_pair(img, img ^ 1, device="cpu")
assert rep["changed_pixels"] == img.size
qa = port.QualityAnalyzer(windowed_ssim=True, device="cpu")
qa.analyze_pair(img, img ^ 1)
assert qa.summary()["count"] == 1.0
assert port.get_embedder("pee", device="cpu").capacity_bits(img) > 0
assert cli.cmd_encode_volume and cli.cmd_analyze and cli.cmd_capacity
from codec_tcc_tpu_torch.parallel import mesh, tile, tile_pee
cpu3 = mesh.make_mesh(devices=["cpu"] * 3, axes=("tile",))
res = tile_pee.encode_array_tiled_pee(img, "tiled pee", pee, cpu3,
                                      bits_stored=12)
dec = tile_pee.decode_container_tiled_pee(res.container, cpu3)
assert dec.message == "tiled pee" and np.array_equal(dec.original, img)
res = tile.encode_array_tiled(img, "tiled", port.EncodeConfig(), cpu3,
                              bits_stored=12)
dec = tile.decode_container_tiled(res.container, cpu3)
assert dec.message == "tiled" and np.array_equal(dec.original, img)
from codec_tcc_tpu_torch.parallel import initialize_distributed
initialize_distributed()           # no world: a no-op
cpu2 = mesh.make_mesh(devices=["cpu"] * 2, axes=("dp",))
for cfg in (port.EncodeConfig(), pee):
    res = batch.encode_batch_containers(np.stack([img, img[::-1]]),
                                        ["d1", "d22"], cfg, cpu2,
                                        bits_stored=12, device="cpu")
    decs = batch.decode_batch_containers(res.containers, cpu2, device="cpu")
    assert [d.message for d in decs] == ["d1", "d22"]
res = volume.encode_volume(np.stack([img, img[::-1]]), "dp volume",
                           port.EncodeConfig(), cpu2, device="cpu")
bits = volume.extract_volume(res.stego, res.plan, cpu2, device="cpu")
assert bytes(np.packbits(bits)) == b"dp volume"
from codec_tcc_tpu_torch.ops import callback_codec
out = callback_codec.roundtrip_in_jit(torch.from_numpy(img), "deflate",
                                      1 << 16)
assert np.array_equal(out.numpy(), img)
loaded = sorted(m for m in sys.modules
                if m == "codec_tcc_tpu" or m.startswith("codec_tcc_tpu.")
                or m == "jax" or m.startswith("jax.") or m.startswith("jaxlib"))
assert loaded == ["jax"], loaded   # only the blocked placeholder
print("OK")
"""


def test_port_imports_and_runs_without_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (REPO, env.get("PYTHONPATH")) if p)
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("OK")


SERVE_SCRIPT = r"""
import sys
sys.modules["jax"] = None          # any `import jax` now raises ImportError
import contextlib, io, json, os, tempfile, threading, time
import numpy as np
import torch
torch.set_num_threads(1)
import codec_tcc_tpu_torch as port
from codec_tcc_tpu_torch import cli, serve
from codec_tcc_tpu_torch.io import dicom

img = (np.arange(48 * 40, dtype=np.uint16).reshape(48, 40) * 7) % 4096
for cfg in (port.EncodeConfig(codec="jls"),
            port.EncodeConfig(codec="jls", container_version=1),
            port.EncodeConfig(codec="jls", strategy="pee")):
    res = port.encode_array(img, "jls, no jax", cfg, bits_stored=12,
                            device="cpu")
    dec = port.decode_container(res.container, device="cpu")
    assert dec.message == "jls, no jax", dec.message
    assert np.array_equal(dec.original, img)
for args in (["doctor", "--no-device", "--json"],
             ["doctor", "--json", "--device", "cpu"]):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert cli.main(args) == 0
    rep = json.loads(out.getvalue())
    assert rep["codecs"]["jls"] == "ok", rep
work = tempfile.mkdtemp(prefix="ct_")
sock = os.path.join(work, "nj.sock")
thread = threading.Thread(
    target=serve.serve, args=(sock,),
    kwargs=dict(warmup="16x16", idle_timeout=60, device="cpu"), daemon=True)
thread.start()
deadline = time.monotonic() + 60
while not os.path.exists(sock) and time.monotonic() < deadline:
    time.sleep(0.05)
assert serve.request(sock, {"op": "ping"})["backend"] == "cpu"
src = os.path.join(work, "in.dcm")
dicom.save_image(img, src, bits_stored=12)
out = os.path.join(work, "out.stgc")
r = serve.request(sock, {"op": "encode", "input": src, "output": out,
                         "message": "served", "config": {"codec": "jls"}})
assert r["ok"], r
r = serve.request(sock, {"op": "decode", "input": out})
assert r["ok"] and r["payload_b64"] == "c2VydmVk", r
assert serve.request(sock, {"op": "shutdown"})["ok"]
thread.join(timeout=30)
loaded = sorted(m for m in sys.modules
                if m == "codec_tcc_tpu" or m.startswith("codec_tcc_tpu.")
                or m == "jax" or m.startswith("jax.") or m.startswith("jaxlib"))
assert loaded == ["jax"], loaded   # only the blocked placeholder
print("OK")
"""


def test_serve_doctor_and_jls_run_without_jax():
    """``serve`` (in a thread, on the CPU), ``doctor`` (host checks and the
    CPU probe) and ``jls`` encodes and decodes (v2, v1, PEE) in a fresh
    interpreter that cannot import jax."""
    from torch_native import build_native_once

    build_native_once()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (REPO, env.get("PYTHONPATH")) if p)
    proc = subprocess.run(
        [sys.executable, "-c", SERVE_SCRIPT], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("OK")


def _port_sources():
    yield os.path.join(REPO, "chip_smoke.py")
    # what chip_smoke.py runs beside the port: its multi-process worker and
    # the cases it reads
    yield os.path.join(REPO, "tests", "torch_multihost_worker.py")
    yield os.path.join(REPO, "tests", "torch_port_cases.py")
    for root, _, files in os.walk(os.path.join(REPO, "codec_tcc_tpu_torch")):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(root, name)


def test_port_sources_never_import_jax():
    offenders = []
    for path in _port_sources():
        with open(path, encoding="utf-8") as f:
            for i, line in enumerate(f, 1):
                code = line.strip()
                if code.startswith(("import jax", "from jax",
                                    "import codec_tcc_tpu ",
                                    "import codec_tcc_tpu.",
                                    "from codec_tcc_tpu ",
                                    "from codec_tcc_tpu.")):
                    offenders.append(f"{path}:{i}: {code}")
    assert offenders == []
