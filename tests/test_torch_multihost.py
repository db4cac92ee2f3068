"""The port's multi-process run against the JAX package's single-process
values, on the CPU: two processes of ``tests/torch_multihost_worker.py``
join a ``gloo`` group through ``parallel.mesh.initialize_distributed``,
each with a ``dp`` mesh of two CPU devices and its half of a global batch
of four; their cut point from the histograms summed across processes and
their stego and bit checksums summed across processes must agree with
each other and equal the JAX package's run of the whole batch in this
process (the values ``tests/test_multihost.py`` holds its two JAX workers
to). Also: ``initialize_distributed`` is a no-op without a world and when
a group exists, and takes its world from the environment (``env://``)."""

import os
import socket
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env():
    env = dict(os.environ)
    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        env.pop(name, None)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (REPO, env.get("PYTHONPATH")) if p)
    return env


def _jax_single_process():
    """``s`` and the checksums of the JAX package's single-process run of
    the workers' global batch (``tests/test_multihost.py``)."""
    from codec_tcc_tpu.config import EncodeConfig
    from codec_tcc_tpu.ops import decompose as decompose_ops
    from codec_tcc_tpu.ops import embed as embed_ops
    from codec_tcc_tpu.ops.histogram import host_histogram
    from codec_tcc_tpu.parallel import batch as batch_par

    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 4096, size=(4, 32, 32)).astype(np.uint16)
    payloads = [rng.integers(0, 2, size=150).astype(np.uint8)
                for _ in range(4)]
    plan = batch_par.plan_batch(imgs, payloads, EncodeConfig(beta=0.4))
    dec = decompose_ops.decompose(
        imgs.reshape(-1, 32), beta=0.4, nbits=16,
        histogram_counts=host_histogram(imgs, 65536),
    )
    chk_stego = chk_bits = 0
    for i in range(4):
        stego = np.asarray(embed_ops.embed(
            imgs[i], plan.msgs[i], plan.starts[i], plan.lengths[i],
            plan.offsets[i], np.int32(plan.s[i]), plan.nbits))
        aligned = np.asarray(embed_ops.extract_aligned(
            stego, plan.starts[i], plan.lengths[i], np.int32(plan.s[i]),
            plan.nbits))
        chk_stego += int(stego.astype(np.int64).sum())
        chk_bits += int(aligned.astype(np.int64).sum())
    return str(dec.s), str(chk_stego), str(chk_bits)


def test_two_process_dp_run_matches_jax_single_process():
    worker = os.path.join(REPO, "tests", "torch_multihost_worker.py")
    port = _free_port()
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(i), "2", str(port), "cpu"],
            env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True,
        )
        for i in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=240)
            assert p.returncode == 0, f"worker failed:\n{out}\n{err[-2000:]}"
            verdicts = [l for l in out.splitlines() if l.startswith("VERDICT")]
            assert len(verdicts) == 1, out
            outs.append(verdicts[0])
    finally:
        for p in procs:           # no orphan worker on timeout or assert
            if p.poll() is None:
                p.kill()

    fields = [dict(kv.split("=") for kv in v.split()[1:]) for v in outs]
    assert {f["proc"] for f in fields} == {"0", "1"}
    assert all(f["nproc"] == "2" and f["devices"] == "4" for f in fields)
    for key in ("s", "chk_stego", "chk_bits"):
        assert fields[0][key] == fields[1][key], key
    # the CPU runs the kernels' plain versions: no launch is counted
    for f in fields:
        counts = dict(kv.split(":") for kv in f["launches"].split(","))
        assert "raster_embed_batch" in counts and "pee_embed" in counts
        assert set(counts.values()) == {"0"}
    s, chk_stego, chk_bits = _jax_single_process()
    assert (fields[0]["s"], fields[0]["chk_stego"], fields[0]["chk_bits"]) \
        == (s, chk_stego, chk_bits)


INIT_SCRIPT = r"""
import os, sys
sys.modules["jax"] = None
import torch.distributed as dist
from codec_tcc_tpu_torch.parallel.mesh import initialize_distributed

initialize_distributed()                      # no address, no world
assert not dist.is_initialized()
os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=sys.argv[1],
                  WORLD_SIZE="1", RANK="0")
initialize_distributed()                      # env://
assert dist.is_initialized() and dist.get_world_size() == 1
assert dist.get_backend() == "gloo"
initialize_distributed("127.0.0.1:1", 2, 1)   # a group exists: no-op
assert dist.get_world_size() == 1 and dist.get_rank() == 0
dist.destroy_process_group()
print("OK")
"""


def test_initialize_distributed_is_a_noop_without_a_world_or_twice():
    proc = subprocess.run(
        [sys.executable, "-c", INIT_SCRIPT, str(_free_port())], cwd=REPO,
        env=_env(), capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("OK")
