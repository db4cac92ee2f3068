"""The port runs where jax does not exist: in a fresh interpreter that
cannot import jax, ``codec_tcc_tpu_torch`` imports, encodes and decodes on
the CPU (raster, block_adaptive, the host embed route and PEE, single
image and batch, the container batch path, the runner, volumes, capacity,
analyze, the embedder models, the CLI and one image tiled across a mesh
of CPU devices, raster and PEE), and nothing of the JAX package
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


def _port_sources():
    yield os.path.join(REPO, "chip_smoke.py")
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
