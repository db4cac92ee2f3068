"""Worker of the port's multi-process run (``tests/test_torch_multihost.py``
on the CPU, ``chip_smoke.py`` phase 3m on the card).

    python tests/torch_multihost_worker.py RANK WORLD PORT [DEVICE]

Each of ``WORLD`` processes joins a ``gloo`` group at
``127.0.0.1:PORT`` through ``parallel.mesh.initialize_distributed``,
builds a ``dp`` mesh of two of its own devices (``DEVICE``, default
``cpu``, repeated) and takes its contiguous part of a global batch of two
images per process (rows ``[rank * 2, rank * 2 + 2)``). On its part it
computes the value histograms per shard (``volume_cut_point`` over the
mesh), sums them across processes (``all_reduce``) for the global cut
point, and embeds and extracts through batch K1/K2, one launch per shard
(``encode_batch``, ``extract_aligned_batch``); the stego and aligned-bit
checksums are summed across processes. It prints one line::

    VERDICT proc=R nproc=W devices=D s=S chk_stego=X chk_bits=Y launches=L

with ``D`` the global device count and ``L`` this process's kernel
launches, ``name:count`` joined by commas. On a CUDA device it loads the kernel library that the
caller built and never builds it.
"""

import sys

rank, world, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
device = sys.argv[4] if len(sys.argv) > 4 else "cpu"

sys.modules["jax"] = None            # the port never needs jax

from dataclasses import replace

import numpy as np
import torch
import torch.distributed as dist

from codec_tcc_tpu_torch import profiling
from codec_tcc_tpu_torch.config import EncodeConfig
from codec_tcc_tpu_torch.ops import decompose as decompose_ops
from codec_tcc_tpu_torch.ops import kernel_library
from codec_tcc_tpu_torch.ops import pee_kernels as pk
from codec_tcc_tpu_torch.ops import raster_kernels as rk
from codec_tcc_tpu_torch.parallel import batch as batch_par
from codec_tcc_tpu_torch.parallel import mesh as mesh_par
from codec_tcc_tpu_torch.parallel import volume as volume_par

torch.set_num_threads(1)
if torch.device(device).type == "cuda":
    path = kernel_library.library_path()
    if not path.exists():
        raise SystemExit(f"kernel library {path} is not built")
    kernel_library.library()

mesh_par.initialize_distributed(f"127.0.0.1:{port}", world, rank)
mesh_par.initialize_distributed(f"127.0.0.1:{port}", world, rank)  # no-op
assert dist.get_world_size() == world and dist.get_rank() == rank

PER_PROC = 2
mesh = mesh_par.make_mesh(devices=[device] * PER_PROC, axes=("dp",))
n_global = PER_PROC * world

# the global batch, the same in every process (the JAX worker's inputs)
rng = np.random.default_rng(0)
imgs = rng.integers(0, 4096, size=(n_global, 32, 32)).astype(np.uint16)
payloads = [rng.integers(0, 2, size=150).astype(np.uint8)
            for _ in range(n_global)]
hists = np.stack([np.bincount(im.reshape(-1), minlength=65536)
                  for im in imgs])
cfg = EncodeConfig(beta=0.4)
plan = batch_par.plan_batch(
    imgs, payloads, cfg, histograms=hists,
    base_offsets=batch_par.hybrid_base_offsets_host(
        imgs, 32, 32, cfg.search_block_size))

rows = slice(rank * PER_PROC, (rank + 1) * PER_PROC)
mine = imgs[rows]
my_plan = replace(            # the global plan's rows of this process
    plan, s=plan.s[rows], starts=plan.starts[rows],
    lengths=plan.lengths[rows], offsets=plan.offsets[rows],
    msgs=plan.msgs[rows], payload_bits=plan.payload_bits[rows],
    base_offsets=plan.base_offsets[rows])

# the global cut point: this process's histogram, summed across processes
_, local_total = volume_par.volume_cut_point(mine, 0.4, mesh, device=device)
total = torch.from_numpy(np.asarray(local_total, dtype=np.int64))
dist.all_reduce(total)
dec = decompose_ops.decompose(
    np.broadcast_to(np.zeros((), np.uint16), (n_global * 32, 32)),
    beta=0.4, nbits=16, histogram_counts=total.numpy())

profiling.get_profiler().reset()
stego = batch_par.encode_batch(mine, my_plan, mesh, device=device)
aligned = batch_par.extract_aligned_batch(stego, my_plan, mesh,
                                          device=device)
checks = torch.tensor([int(stego.to(torch.int64).sum()),
                       int(aligned.to(torch.int64).sum())],
                      dtype=torch.int64)
launches = ",".join(f"{k}:{v}" for k, v in
                    profiling.launches(rk.KERNELS + pk.KERNELS).items())
dist.all_reduce(checks)
devices = torch.tensor([mesh.size], dtype=torch.int64)
dist.all_reduce(devices)

print(
    f"VERDICT proc={rank} nproc={world} devices={int(devices)} s={dec.s} "
    f"chk_stego={int(checks[0])} chk_bits={int(checks[1])} "
    f"launches={launches}",
    flush=True,
)
dist.destroy_process_group()
