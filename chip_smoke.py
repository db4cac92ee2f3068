#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``codec_tcc_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Drives the port's encode/decode paths (raster, PEE, block_adaptive, the
host embed route, the container batch path, the STGV volume path, with
capacity and analyze, one image split by rows across a mesh, a batch
split over a mesh's ``dp`` axis and over two processes, the other
transport codecs with STGC v1, and the serving daemon) through
its hand-written CUDA kernels (K1 ``raster_embed`` and its batch form
``raster_embed_batch``, K2 ``raster_extract`` and ``raster_extract_batch``,
K3 ``pee_embed``, K4 ``pee_extract`` and their band mode, two launches
each: ``pee_count_band`` and ``pee_embed_band``, ``pee_extract_count_band``
and ``pee_extract_band``; the deflate kernels ``deflate_rle_tokens``,
``deflate_rle_trees`` and ``deflate_rle_emit``, which compress the stego of
a single-image encode on the card) and checks them, phase by phase; any
failure exits non-zero:

1. prints the card's name and power limit (``nvidia-smi``), builds the
   kernels from ``codec_tcc_tpu_torch/csrc`` with ``nvcc`` (sm_90a; one
   compile per source, all at once, linked into one library); builds the
   ``jls`` codec's library from ``codec_tcc_tpu_torch/native`` with
   ``g++`` (and the ``jxl`` shim where a system libjxl exists) and prints
   the build time, whether libjxl was found and the shim built, and the
   available codecs;
2. every kernel against its plain torch version on the card, exact, at
   512x512 / 2048x2048 / 480x640 uint16 and 500x501 uint8: K1/K2 with s in
   {1, 4, 8} and wrapping, aliased and past-s windows; K1 on the plans of
   ``tests/torch_raster_cases.py::k1_plans`` (window starts, ends and
   message offsets at every residue mod 16 in pixel order, wraps
   mid-chunk, the message ending mid-chunk, sixteen planes at s = 12 on
   uint8 with maps, whose rows 8-11 must be zero) at uint8 and uint16, the
   image and the message at an aligned and an odd element address; K2 on
   the boundary plans there (segment ends at every residue mod 16, wraps
   mid-chunk, odd starts, ``out_len`` 1, 15, 16, 17 and past every window)
   at uint8 and uint16, the stego at an aligned and an odd element
   address; each then on a 2048x2048 five-plane plan launched 20 times with
   identical outputs; the batch forms of K1/K2 at B in {1, 3, 32}, each
   image on its own K1 plan (cut points 1 to 16, images and map rows off
   16-byte alignment), at B = 64 with sixteen-plane segment tables (more
   than one launch's parameters hold), at B = 1 against the single-image
   wrappers and at B = 32 x 512x512 and B = 8 x 2048x2048 uint16 on
   five-plane plans, 5 identical repeats; K3/K4 on batches of three with
   both parities, T in
   {1, 2, 47, 128}, per-image wants of 0, under capacity and over it
   (saturated), then 2**30 (the message-index clamp), and an ``out_len``
   below the expanded count, and on bright uint8 batches at ``max_val``
   4095 (BitsStored 12: pixels wrap past 255, as in the JAX package); then
   the K3 and
   K4 look-back stress cases of ``tests/torch_pee_stress.py``: K3 at wants
   at and beside the tile boundaries, 0, 1, cap, cap + 1 (narrow, wide and
   unaligned batches), each inverted by K4 back to the image; K4 with
   ``out_len`` at 1, 8 and the expanded count at and beside the tile
   boundaries, ``nproc`` at 0, 1, H*W, 2**31 - 1 and -5, and on forged
   stego and overflow bytes with ``nproc`` at set ranks that straddle the
   tile boundaries; each exact against the plain version; then a launch of
   each on 8 x 2048x2048 uint16 (8,192 tiles) repeated 20 times with
   identical outputs; then the device block extract (torch ops, no
   kernel) against ``extract_block_host`` on the stegos of the five
   ``blk_*`` cases, with the case's cut point and one lower; then K3/K4's
   band launches against their plain versions on the 2048x2048 uint16
   image of the 3 Mbit PEE case at its T, over 4 bands (pass 0 saturated
   and at half its capacity, pass 1 on pass 0's stego): every band's tile
   counts and outputs exact, the used count and boundary exact, the bands
   stitched together equal to the whole-image K3/K4. Before all of these,
   the deflate kernels (after the probe against host zlib that their
   first use in a process runs) against their plain NumPy version and
   host zlib, byte for byte, on the corpus of
   ``tests/torch_deflate_cases.py``, the probe's images and the
   benchmark's phantoms at 512x512 and 2048x2048 uint16, the larger 5
   times identical; and the inflate kernels (``inflate_scan``,
   ``inflate_measure``, ``inflate_chain``, ``inflate_emit``, which inflate
   the stego of a single-image decode on the card) against host zlib,
   exact, on the payloads of ``tests/torch_inflate_cases.py`` (with the
   plain version's counts of candidates, chain blocks and serial blocks,
   ``tests/torch_inflate_plain.py``) and the phantoms at 512x512 and
   2048x2048 on three seeds, one launch of each a call, the larger 5
   times identical, and the payloads they leave to the host codec with
   its result or message;
3. every case of ``tests/data/torch_port_parity.json`` (six raster, six
   PEE, five block_adaptive, three on the host embed route) through
   ``encode_array(device="cuda")``: the container's sha256 (and for PEE the
   ext tuple) must equal the JAX package's, and
   ``decode_container(device="cuda")`` must give the payload and the
   original back exactly; then ``encode_pee_batch``/``decode_pee_batch`` on
   the four 512x512 uint16 case images as one batch of mixed T; the F1
   batch (``torch_port_cases.f1_batch``: an escalation group of three
   entries that holds an image twice) equal to the JAX package's
   containers and decoding to its payloads; then the container batch
   path: ``encode_batch_containers`` at B = 32 x 512x512
   and B = 8 x 2048x2048 uint16 (device route: one K1 launch per batch),
   B = 32 on the host route and a block_adaptive batch of four, every
   container equal to the single-image ``encode_array`` container and, for
   the parity cases in the batches, to the JAX package's;
   ``extract_batch`` (one K2 launch) gives the payloads back, and
   ``decode_batch_containers`` over all of them, mixed, the payloads and
   originals;
3v. the volume path (``tests/torch_port_cases.py::VOLUME_CASES``):
   ``encode_volume`` + ``pack_volume`` on the 64x512x512 uint16 volume of
   BASELINE.json config[3] under ``hybrid`` and ``multi_plane`` with the
   304-bit text and with half its LSB capacity, PEE on 8x512x512 uint16
   with 1 Mbit, ``block_adaptive`` on 8x512x512 uint16 and a 5x500x501
   uint8 volume (raw maps): every STGV sha256 equal to the JAX package's,
   ``unpack_volume`` gives the payload and the volume back and
   ``extract_volume`` the payload; batch K1/K2 against their plain
   versions at each raster volume's own plan; ``golden_block_volume.stgv``
   decodes; ``capacity_report`` on ``mr512_u16`` and on the 64-slice volume
   equals the JAX package's dict; ``analyze_pair`` (device moments, and the
   float64 branch) equals the fixture's within rtol 1e-4 / 1e-12;
3c. the other transport codecs on the card (``CODEC_CASES``):
   ``encode_array``/``decode_container`` with ``codec="jls"`` on the
   images of ``mr512_u16``, ``ot512_u8``, ``odd640x480_u16``,
   ``cr2048_u16_full``, ``pee_mr512_u16_text`` and ``blk_mr512_u16``, and
   v1 + ``jls`` hybrid on ``mr512_u16``; a ``jls`` volume (8 x 512x512
   uint16 hybrid, 304 bits): every container and the STGV equal to the JAX
   package's (the fixture's ``codecs`` section), payloads and originals
   exact; without Pillow ``png``/``j2k`` report unavailable and ``get``
   raises ``RuntimeError``, with Pillow their round trips on ``mr512_u16``
   are exact; where the ``jxl`` shim built, a ``jxl`` round trip on
   ``mr512_u16`` is exact (the bytes of these three are printed, not
   compared: they depend on the Pillow and libjxl builds);
3t. one image across a mesh of the card repeated K times
   (``parallel.make_mesh(devices=["cuda:0"] * K)``):
   ``encode_array_tiled_pee``/``decode_container_tiled_pee`` on the
   2048x2048 3 Mbit PEE case for K = 1, 2, 4 (the container equal to the
   single-device one and to the JAX package's tiled one, the fixture's
   ``tiled`` section) and on a 4096x3328 uint16 mammography frame with 6
   Mbit over 4 bands (equal to the single-device container, both passes
   used); ``encode_array_tiled``/``decode_container_tiled`` at 4096x3328
   for hybrid and block_adaptive over 4 bands (equal to ``encode_array``);
   every decode exact;
3d. batches split over the ``dp`` axis of a mesh of the card repeated
   (``make_mesh(devices=["cuda:0"] * K, axes=("dp",))`` for K = 1, 2, 4,
   and a (2, 2) ``("dp", "tile")`` mesh, the counterpart of the JAX
   package's ``dryrun_multichip``): ``encode_batch_containers`` and
   ``extract_batch`` on phase 3's B = 32 x 512x512 and B = 8 x 2048x2048
   uint16 batches, ``encode_volume`` + ``pack_volume`` and
   ``extract_volume`` on the 64 x 512x512 volume at half its LSB
   capacity, ``encode_pee_batch`` and ``decode_batch_containers`` on an
   8 x 512x512 uint16 PEE batch of parity phantoms, and the F1 batch over
   ``dp`` = 1 and 3 (over 2 it raises ``ValueError``, as in the JAX
   package): containers and STGV equal to the unsharded run and to the
   fixture's ``cases``, ``volumes`` and ``tiled`` hashes where the case is
   there, payloads and originals exact;
3m. two processes of ``tests/torch_multihost_worker.py`` on ``cuda:0``,
   joined by ``gloo`` through ``parallel.mesh.initialize_distributed``,
   each with a ``dp`` mesh of two shards and half of a global batch of
   four; they load the library phase 1 built. Their cut point (histograms
   summed across the processes) and stego and bit checksums equal the
   same batch run unsharded in this process;
4. the committed golden raster, block_adaptive and PEE containers decode
   on the card;
5. ``python -m codec_tcc_tpu_torch encode`` / ``decode`` as subprocesses on
   DICOMs written by the port, default strategy, ``--strategy pee``,
   ``--strategy block_adaptive`` and ``--device-policy host``, then
   ``encode-batch`` (the per-item runner, and ``--fused`` with the default
   strategy and with ``--strategy pee``) and ``decode-batch`` over three
   of them: container, message and restored pixels exact; then
   ``encode-volume`` / ``decode-volume --dicom`` on the 64-slice volume
   (STGV equal to the JAX package's), ``capacity --json`` on it,
   ``analyze --windowed-ssim``, ``analyze-batch`` and ``demo``;
5s. the serving daemon, ``serve.serve(sock, warmup="512x512",
   device="cuda")`` in a thread of this process: ``ping`` answers
   ``backend == "cuda"``; ``encode``/``decode`` of DICOM files of the
   ``mr512_u16`` and ``pee_mr512_u16_text`` images (and a ``jls`` request),
   ``encode_batch`` of four 512x512 files (one batch K1) and
   ``decode_batch``, ``encode_volume``/``decode_volume`` of an 8 x 512x512
   ``.npy``, ``capacity`` and ``analyze``: containers, STGV, capacity and
   analyze equal to the JAX package's (the fixture's ``serve`` section:
   ``encode_file`` on the same files), payloads and originals exact; a
   bad request answers ``ok: false`` and the daemon lives on; the warm
   latencies; ``shutdown`` ends the thread;
6. the launch counts of each path, set to 0 just before it and read just
   after it: the raster cases (K1 and K2 once per encode and decode), the
   PEE cases and the PEE batch (K3 twice per equal-T attempt group, K4
   twice per decode group), the block cases (torch ops both ways, no
   launch), the host-route cases (no K1, K2 once per decode), each
   deflate kernel once per single-image encode on the card (the raster,
   PEE and block cases, the daemon's ``deflate`` encodes; none on the host
   route and the batch, volume, tiled and other-codec paths), each
   inflate kernel once per single-image decode of a ``deflate`` stego on
   the card (the raster, PEE, block and host-route cases, the daemon's
   ``deflate`` decodes; none for the golden fixtures' code 2 and the
   batch, volume, tiled and other-codec paths), the golden
   decodes and the batch paths (one batch K1 per device-route batch
   encode, one batch K2 per ``extract_batch``, none for the host and
   block batches and the batch decode), the volumes (one
   batch K1 per raster volume encode, one batch K2 per ``extract_volume``,
   none for a raster or block ``unpack_volume``, K3 twice per equal-T
   attempt group of the PEE volume, K4 twice per decode group), the
   capacity probes (K3 twice each), analyze (none), the F1 batch (as the
   PEE batch) and the tiled paths (K3's band count and apply launches
   once per band per pass per attempt, replayed from the start and final
   T, K4's band count and apply once per band per inverse pass; no kernel
   for the tiled raster path), the ``dp``
   paths (batch K1, batch K2 and K3 once per non-empty shard: one batch
   K1 per shard of a batch or volume encode, one batch K2 per shard of
   ``extract_batch`` or ``extract_volume``, K3 twice per non-empty shard
   of each PEE attempt group, K4 twice per threshold group of the decode
   on the first ``dp`` device), each worker of phase 3m (batch K1 and K2
   once per shard, counted in the worker), the codecs (as
   raster, PEE and block per case; one batch K1 for the jls volume) and
   each daemon request (as the entry point it calls); every count must be
   exactly what the path should launch, so every kernel runs on the path
   that needs it;
7. times, printed and not asserted: per call of each kernel and of its
   plain version (median of 20 CUDA-event reps, wrapper included; and
   device time alone from ``torch.profiler``) at the main path's shapes:
   K1/K2 at the 512x512 and 2048x2048 uint16 capacity plans (and each one's
   share of its bound's rate beside a torch copy of its bytes), K3/K4 at the
   2048x2048 3 Mbit PEE plan (pass 0 and pass 1); the block encode's device
   work at ``blk_cr2048_u16_full`` op by op (tile popcounts, embed, packed
   maps, moments; profiler ops and bounds); the encode host wall with
   ``compute_metrics=False`` under ``device_policy`` ``"device"`` and
   ``"host"`` at ``mr512_u16_full`` and ``cr2048_u16_full``; warm
   encode+decode cycles (host wall, stage means, device busy share): raster
   512x512 with 304 bits, block_adaptive 512x512 with 304 bits, PEE 512x512
   with 304 bits and PEE 2048x2048 with 3 Mbit; the batch K1/K2 at the
   container batches' inputs (B = 32 x 512x512 and B = 8 x 2048x2048
   uint16) beside their plain versions and B single-image launches, with
   their bounds; and the host walls of ``encode_batch_containers`` (under
   ``device_policy`` "device" and "host" without metrics, and the default
   config) and ``decode_batch_containers`` at B = 32 x 512x512 uint16 with
   304 bits, with their stage means; the host walls of ``encode_volume`` +
   ``pack_volume``, ``unpack_volume`` and ``extract_volume`` at the
   64x512x512 uint16 hybrid volume with half its LSB capacity (median of
   3, stage means), and batch K1/K2 at that volume's plan (per call,
   device, queued with L2 flushed, bound); the ``dp`` walls over K = 1, 2,
   4 shards of the card, in turns: ``encode_batch_containers`` and
   ``decode_batch_containers`` at B = 32 x 512x512 (median of 5),
   ``encode_volume`` + ``pack_volume`` and ``extract_volume`` at the
   64-slice volume (median of 3), and batch K1/K2 device time per shard;
   the tiled PEE encode and decode
   walls at 2048x2048 for K = 1, 2, 4 beside the single-device ones, in
   turns, and K3/K4's band launches band by band at K = 4 on the case's
   four passes and on band 1 of the 4096x3328 frame (per call, device,
   plain, each launch's bound), with K4's look-back design at the same
   band beside them; ``jls`` against ``deflate``: the
   ``transport_codec`` and ``transport_decode`` stage means, the cycle's
   host wall and the container bytes at 512x512 (304 bits) and 2048x2048
   (at capacity) uint16; the deflate kernels on the phantoms at 512x512
   and 2048x2048 uint16 (each launch's device time and bound, the per-call
   wall of ``encode_device`` with its read-back, host zlib beside it); the
   inflate kernels on the same phantoms (each launch's device time and
   its bound from its own bytes, a call's device time, the host walls of
   a call and of the stego's download, ``inflate_device`` and
   ``transport_decode`` per call, host zlib's decode beside them); the
   warm daemon's ``encode`` and ``decode`` latency at 512x512 uint16 with
   304 bits (median of 5).

Before the last line it prints the ``nvidia-smi`` line and one JSON line
``{"kernels": [...]}`` (per kernel: launches, launches by path, max abs
error, times, and the bound: the larger of its bytes over 3.35 TB/s and its
integer operations over 67 TOP/s, from this run's shapes; the deflate
kernels' ``library_ms`` is host zlib's encode, the inflate kernels' its
decode); the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a GPU, or without the rest of the repository beside it, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPS = 20
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
INT_OPS_PER_S = 67e12         # H100 SXM peak outside the tensor cores
# Essential integer operations per unit of work, counted from the
# functions (not from the kernels' index arithmetic): K1 3 per embedded
# (pixel, plane) and 1 per map bit, K2 3 per payload bit, K3/K4 20 per
# pixel (prediction 5, error and classification 10, rank and update 5).
K3_K4_OPS_PER_PIXEL = 20


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def phase(n, msg: str) -> None:
    print(f"phase {n}: {msg}", flush=True)


def cuda_median_ms(fn, reps: int = REPS) -> float:
    """Median device time of ``fn()`` over ``reps`` runs, CUDA events."""
    import torch

    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, reps: int = REPS):
    """Device time per call of ``fn()``: the sum of the CUDA kernels and
    copies ``torch.profiler`` records over ``reps`` calls, divided by
    ``reps`` (host overhead excluded). None when the profiler records no
    device activity."""
    total = sum(ms for _, ms in device_ops_ms(fn, reps))
    return total if total > 0 else None


def queued_ms(fn, cold: bool, reps: int = 10) -> float:
    """Device time of ``fn()`` from CUDA events, with the host's part
    hidden: a spin kernel of about 10 ms is queued first, so every launch
    of ``fn`` is queued before the card reaches the start event and they
    run back to back (launch gaps, and the L2 write-backs a gap would
    absorb, count). ``cold``: a read of 128 MB between the spin and the
    start event leaves nothing of the previous call in the 50 MB L2, and
    clean lines only, so no write-back of the flush is charged. Median of
    ``reps``."""
    import torch

    flush_buf = torch.ones(32 << 20, dtype=torch.int32, device="cuda")
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        if cold:
            flush_buf.amax()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def fmt_ms(v) -> str:
    return "not measured" if v is None else f"{v:.4f} ms"


def bound(nbytes: int, ops: int):
    """(bound_ms, bound_by): the larger of the bytes' and the operations'
    least times on the card."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k1_work(n: int, itemsize: int, s: int, lens, msg_bits: int):
    """(bytes, operations) of K1's function on N pixels: the image read and
    the stego written once, s packed map planes written, the message bytes
    read once; 3 operations per embedded (pixel, plane), 1 per map bit."""
    nbytes = 2 * itemsize * n + s * n // 8 + msg_bits
    ops = 3 * sum(min(int(v), n) for v in lens[:s]) + s * n
    return nbytes, ops


def max_abs_diff(got, ref) -> int:
    """Largest |got - ref| over the tensors of two equal-length tuples."""
    import torch

    err = 0
    for g, r in zip(got, ref):
        if g is None and r is None:
            continue
        d = (g.to(torch.int64) - r.to(torch.int64)).abs()
        err = max(err, int(d.max()) if d.numel() else 0)
    return err


def kernel_vs_plain_cases(rng, n):
    """(s, starts, lens, offs) plans for phase 2: random windows that wrap
    past the raster end, plus aliased message offsets and a past-s plane
    with a nonzero length."""
    plans = []
    for s in (1, 4, 8):
        starts = rng.integers(0, n, 8)
        starts[0] = n - 3                       # wraps
        lens = rng.integers(0, n + 1, 8)
        lens[0] = n
        offs = rng.integers(0, 4 * n, 8)
        plans.append((s, starts, lens, offs))
    plans.append((3, [n - 11, 5, 0, 9, 0, 0, 0, 0],
                  [400, 300, 200, 777, 0, 0, 0, 0],
                  [0, 0, 350, 123, 0, 0, 0, 0]))
    return plans


PHASE2_SHAPES = ((512, 512, "uint16", 12), (2048, 2048, "uint16", 12),
                 (480, 640, "uint16", 12), (500, 501, "uint8", 8))


def phase2_raster(rng, dev) -> dict:
    import numpy as np
    import torch
    from codec_tcc_tpu_torch.ops import raster_kernels as rk

    max_err = {"raster_embed": 0, "raster_extract": 0}
    for h, w, dt, _ in PHASE2_SHAPES:
        dt = np.dtype(dt)
        n = h * w
        hi = 1 << (8 * dt.itemsize)
        img = torch.from_numpy(rng.integers(0, hi, (h, w)).astype(dt)).to(dev)
        msg = torch.from_numpy(
            rng.integers(0, 2, 5 * n).astype(np.uint8)).to(dev)
        for s, starts, lens, offs in kernel_vs_plain_cases(rng, n):
            emit = n % 8 == 0
            got = rk.raster_embed(img, msg, starts, lens, offs, s,
                                  emit_maps=emit)
            torch.cuda.synchronize()
            ref = rk.raster_embed_plain(img, msg, starts, lens, offs, s,
                                        emit_maps=emit)
            err = max_abs_diff(got, ref)
            max_err["raster_embed"] = max(max_err["raster_embed"], err)
            check(err == 0, f"K1 != plain at {h}x{w} {dt.name} s={s}")
            out_len = int(max(int(o) + int(ln) for o, ln in zip(offs, lens)))
            ex_k = rk.raster_extract(got[0], starts, lens, offs, s, out_len)
            torch.cuda.synchronize()
            ex_p = rk.raster_extract_plain(got[0], starts, lens, offs, s,
                                           out_len)
            err = max_abs_diff((ex_k,), (ex_p,))
            max_err["raster_extract"] = max(max_err["raster_extract"], err)
            check(err == 0, f"K2 != plain at {h}x{w} {dt.name} s={s}")
    return max_err


K1_SHAPES = ((64, 64, "uint8"), (64, 64, "uint16"), (40, 41, "uint8"),
             (40, 41, "uint16"), (61, 67, "uint16"), (500, 501, "uint8"))


def phase2_k1(dev) -> tuple:
    """K1 against its plain version on the plans of
    ``tests/torch_raster_cases.py::k1_plans`` (window starts, ends and
    message offsets at every residue mod 16, wraps mid-chunk, windows
    longer than N, past-s planes, aliased offsets, the message ending
    mid-chunk, sixteen planes at s = 12), maps wherever H*W % 8 == 0 (N/8
    odd at 40x41), the image and the message at an aligned and at an odd
    element address (views one element into their buffers); on uint8 the
    sixteen-plane plan must leave map rows 8-11 zero (the stego narrowed
    before the maps); then a 2048x2048 uint16 five-plane plan with maps
    launched 20 times: every output identical. Returns (max abs error,
    text for phase 2)."""
    import numpy as np
    import torch
    import torch_raster_cases as rc
    from codec_tcc_tpu_torch.ops import raster_kernels as rk

    rng = np.random.default_rng(2027)
    err = count = repaired = 0

    def one(img, msg, plan, emit, what):
        nonlocal err, count
        label, s, starts, lens, offs, _ = plan
        got = rk.raster_embed(img, msg, starts, lens, offs, s, emit_maps=emit)
        torch.cuda.synchronize()
        ref = rk.raster_embed_plain(img, msg, starts, lens, offs, s,
                                    emit_maps=emit)
        e = max_abs_diff(got, ref)
        err = max(err, e)
        count += 1
        check(e == 0, f"K1 != plain on {label} ({what})")
        return got

    for h, w, dt in K1_SHAPES:
        n = h * w
        dt = np.dtype(dt)
        emit = n % 8 == 0
        for shift in (0, 1):
            buf = torch.from_numpy(rng.integers(
                0, 1 << (8 * dt.itemsize), n + shift).astype(dt)).to(dev)
            img = buf[shift:].view(h, w)
            what = f"{h}x{w} {dt.name}, shift {shift}"
            for plan in rc.k1_plans(n, seed=n):
                bits = torch.from_numpy(rng.integers(
                    0, 2, plan[5] + shift).astype(np.uint8)).to(dev)
                maps = one(img, bits[shift:], plan, emit, what)[1]
                if plan[0] == "sixteen_planes" and emit and dt.itemsize == 1:
                    check(not maps[8:].any(),
                          f"K1 wrote map rows 8-11 on uint8 ({what})")
                    repaired += 1
    check(repaired == 4, f"the uint8 sixteen-plane case ran {repaired} times")
    h = w = 2048
    img = torch.from_numpy(
        rng.integers(0, 4096, (h, w)).astype(np.uint16)).to(dev)
    plan = rc.five_plane_plan(h * w, seed=5)
    msg = torch.from_numpy(
        rng.integers(0, 2, plan[5]).astype(np.uint8)).to(dev)
    first = one(img, msg, plan, True, "2048x2048 uint16")
    for rep in range(20):
        again = rk.raster_embed(img, msg, *plan[2:5], plan[1], emit_maps=True)
        check(all(torch.equal(a, b) for a, b in zip(again, first)),
              f"K1 repeat {rep} on the 2048x2048 five-plane plan differs")
    return err, (f"K1 {count} plans exact (uint8 s=12 map rows 8-11 zero "
                 f"at 64x64 and 40x41, both addresses), 20 identical "
                 f"repeats of the 2048x2048 five-plane plan with maps")


K2_SHAPES = ((64, 64, "uint16"), (37, 53, "uint8"), (61, 67, "uint16"),
             (500, 501, "uint8"))


def phase2_k2(dev) -> tuple:
    """K2 against its plain version on the boundary plans of
    ``tests/torch_raster_cases.py``, the stego at an aligned and at an odd
    element address (a view one element into its buffer), then on a
    2048x2048 uint16 five-plane plan launched 20 times: every output
    identical. Returns (max abs error, text for phase 2)."""
    import numpy as np
    import torch
    import torch_raster_cases as rc
    from codec_tcc_tpu_torch.ops import raster_kernels as rk

    rng = np.random.default_rng(2026)
    err = count = 0

    def one(stego, plan, what):
        nonlocal err, count
        label, s, starts, lens, offs, out_len = plan
        got = rk.raster_extract(stego, starts, lens, offs, s, out_len)
        torch.cuda.synchronize()
        ref = rk.raster_extract_plain(stego, starts, lens, offs, s, out_len)
        e = max_abs_diff((got,), (ref,))
        err = max(err, e)
        count += 1
        check(e == 0, f"K2 != plain on {label} ({what})")
        return got

    for h, w, dt in K2_SHAPES:
        n = h * w
        dt = np.dtype(dt)
        for shift in (0, 1):
            buf = torch.from_numpy(rng.integers(
                0, 1 << (8 * dt.itemsize), n + shift).astype(dt)).to(dev)
            stego = buf[shift:].view(h, w)
            for plan in rc.boundary_plans(n, seed=n):
                one(stego, plan, f"{h}x{w} {dt.name}, shift {shift}")
    h = w = 2048
    stego = torch.from_numpy(
        rng.integers(0, 4096, (h, w)).astype(np.uint16)).to(dev)
    plan = rc.five_plane_plan(h * w, seed=5)
    first = one(stego, plan, "2048x2048 uint16")
    for rep in range(20):
        again = rk.raster_extract(stego, *plan[2:5], plan[1], plan[5])
        check(torch.equal(again, first),
              f"K2 repeat {rep} on the 2048x2048 five-plane plan differs")
    return err, (f"K2 {count} boundary plans exact, 20 identical repeats of "
                 f"the 2048x2048 five-plane plan ({plan[5]} bits)")


BATCH_SHAPES = ((64, 64, "uint16"), (40, 41, "uint8"), (40, 41, "uint16"),
                (37, 53, "uint8"))


def phase2_batch(dev) -> tuple:
    """The batch kernels against their plain versions: K1 and K2 at B in
    {1, 3, 32}, each image on its own plan of
    ``tests/torch_raster_cases.py::k1_plans`` (cut points 1 to 16; at
    40x41 and 37x53 the images of a batch start off 16-byte alignment and
    a map row is an odd number of bytes); B = 64 tables of sixteen-plane
    segment plans (64 x 788 bytes, more than the launch parameters of one
    launch hold); B = 1 against the single-image wrappers; then the main
    path's shapes, B = 32 x 512x512 and B = 8 x 2048x2048 uint16 on
    five-plane capacity plans, launched 5 times with identical outputs.
    Returns (max abs errors, text for phase 2)."""
    import numpy as np
    import torch
    import torch_raster_cases as rc
    from codec_tcc_tpu_torch.ops import raster_kernels as rk

    rng = np.random.default_rng(2028)
    err = {"raster_embed_batch": 0, "raster_extract_batch": 0}
    count = 0

    def inputs(b, h, w, dt, plans):
        dt = np.dtype(dt)
        imgs = torch.from_numpy(rng.integers(
            0, 1 << (8 * dt.itemsize), (b, h, w)).astype(dt)).to(dev)
        s, starts, lens, offs, out_len = rc.batch_plans(plans, b)
        msgs = torch.from_numpy(
            rng.integers(0, 2, (b, out_len)).astype(np.uint8)).to(dev)
        return imgs, msgs, (starts, lens, offs, s), out_len

    def one(imgs, msgs, plan, out_len, what, repeats=0):
        nonlocal count
        emit = imgs[0].numel() % 8 == 0
        got = rk.raster_embed_batch(imgs, msgs, *plan, emit_maps=emit)
        torch.cuda.synchronize()
        ref = rk.raster_embed_batch_plain(imgs, msgs, *plan, emit_maps=emit)
        e = max_abs_diff(got, ref)
        err["raster_embed_batch"] = max(err["raster_embed_batch"], e)
        check(e == 0, f"batch K1 != plain ({what})")
        bits = None
        for length in (out_len, 17):
            bits = rk.raster_extract_batch(got[0], *plan, length)
            torch.cuda.synchronize()
            want = rk.raster_extract_batch_plain(got[0], *plan, length)
            e = max_abs_diff((bits,), (want,))
            err["raster_extract_batch"] = max(err["raster_extract_batch"], e)
            check(e == 0, f"batch K2 != plain ({what}, out_len {length})")
        count += 1
        for rep in range(repeats):
            again = rk.raster_embed_batch(imgs, msgs, *plan, emit_maps=emit)
            check(all(torch.equal(a, b) for a, b in zip(again, got)),
                  f"batch K1 repeat {rep} differs ({what})")
            check(torch.equal(rk.raster_extract_batch(got[0], *plan, 17),
                              bits),
                  f"batch K2 repeat {rep} differs ({what})")
        return got

    for h, w, dt in BATCH_SHAPES:
        plans = rc.k1_plans(h * w, seed=h * w)
        for b in (1, 3, 32):
            one(*inputs(b, h, w, dt, plans), f"B={b} {h}x{w} {dt}")
    for dt in ("uint8", "uint16"):
        n = 30 * 40
        plans = [rc.many_segment_plan(n), rc.sixteen_plane_plan(n)]
        one(*inputs(64, 30, 40, dt, plans), f"B=64 30x40 {dt}")
    for plan in rc.k1_plans(512 * 512, seed=3)[::5]:
        imgs, msgs, bplan, out_len = inputs(1, 512, 512, "uint16", [plan])
        got = one(imgs, msgs, bplan, out_len, f"B=1 512x512 {plan[0]}")
        starts, lens, offs, s = (v[0] for v in bplan)
        single = rk.raster_embed(imgs[0], msgs[0], starts, lens, offs,
                                 int(s), emit_maps=True)
        check(torch.equal(single[0], got[0][0])
              and torch.equal(single[1], got[1][0]),
              f"batch K1 at B=1 != the single-image K1 ({plan[0]})")
        bits = rk.raster_extract_batch(got[0], *bplan, out_len)
        check(torch.equal(rk.raster_extract(single[0], starts, lens, offs,
                                            int(s), out_len), bits[0]),
              f"batch K2 at B=1 != the single-image K2 ({plan[0]})")
    for b, side in ((32, 512), (8, 2048)):
        n = side * side
        plans = [rc.five_plane_plan(n, seed=i) for i in range(b)]
        one(*inputs(b, side, side, "uint16", plans),
            f"B={b} {side}x{side} uint16", repeats=5)
    return err, (f"batch K1/K2 {count} batches exact (B in 1, 3, 32 and 64, "
                 f"unaligned images, B=1 == single-image wrappers), 5 "
                 f"identical repeats at B=32x512^2 and B=8x2048^2")


def phase2_pee(dev) -> dict:
    """K3/K4 against their plain versions on batches of three phantoms with
    a row at the ceiling and a column at 0 (overflow pixels)."""
    import numpy as np
    import torch
    import torch_port_cases as cases
    from codec_tcc_tpu_torch.ops import pee_kernels as pk

    rng = np.random.default_rng(2025)
    max_err = {"pee_embed": 0, "pee_extract": 0}
    i32 = dict(dtype=torch.int32, device=dev)
    for h, w, dt, bits_stored in PHASE2_SHAPES:
        n = h * w
        max_val = (1 << bits_stored) - 1
        imgs = np.stack([cases.image(cases.Case(
            "k", h, w, dt, bits_stored, "text", "pee", 300 + k))
            for k in range(3)])
        imgs[:, h // 3, :] = max_val
        imgs[:, :, w // 4] = 0
        imgs = torch.from_numpy(imgs).to(dev)
        msg = torch.from_numpy(
            rng.integers(0, 2, (3, n // 2)).astype(np.uint8)).to(dev)
        base = torch.tensor([0, 5, 11], **i32)
        for t in (1, 2, 47, 128):
            for parity in (0, 1):
                cap = pk.pee_embed(imgs, msg, base, torch.zeros(3, **i32),
                                   parity, t, max_val)[4].cpu()
                mixed = torch.tensor(
                    [0, int(cap[1]) // 2, int(cap[2]) + 1], **i32)
                for want in (mixed, torch.full((3,), 1 << 30, **i32)):
                    got = pk.pee_embed(imgs, msg, base, want, parity, t,
                                       max_val)
                    torch.cuda.synchronize()
                    ref = pk.pee_embed_plain(imgs, msg, base, want, parity,
                                             t, max_val)
                    err = max_abs_diff(got, ref)
                    max_err["pee_embed"] = max(max_err["pee_embed"], err)
                    check(err == 0, f"K3 != plain at {h}x{w} {dt} T={t} "
                                    f"parity={parity} want={want.tolist()}")
                    stego, over, _, nproc, _ = got
                    for out_len in (8, n):
                        gx = pk.pee_extract(stego, over, nproc, parity, t,
                                            out_len)
                        torch.cuda.synchronize()
                        rx = pk.pee_extract_plain(stego, over, nproc, parity,
                                                  t, out_len)
                        err = max_abs_diff(gx, rx)
                        max_err["pee_extract"] = max(max_err["pee_extract"],
                                                     err)
                        check(err == 0,
                              f"K4 != plain at {h}x{w} {dt} T={t} parity="
                              f"{parity} out_len={out_len}")
                        check(torch.equal(gx[0], imgs),
                              f"K4 did not restore {h}x{w} {dt} T={t}")
    phase2_pee_u8_wide(dev, max_err)
    return max_err


def phase2_pee_u8_wide(dev, max_err) -> None:
    """K3/K4 against their plain versions on bright uint8 images at
    ``max_val`` 4095 (BitsStored 12): expanded pixels wrap past 255 as in
    the JAX package, so only the plain version is the reference (the image
    does not come back). Updates ``max_err``."""
    import numpy as np
    import torch
    import torch_port_cases as cases
    from codec_tcc_tpu_torch.ops import pee_kernels as pk

    rng = np.random.default_rng(4095)
    i32 = dict(dtype=torch.int32, device=dev)
    imgs = torch.from_numpy(np.stack([238 + cases.image(cases.Case(
        "k", 500, 501, "uint8", 8, "text", "pee", 310 + k)) // 15
        for k in range(3)]).astype(np.uint8)).to(dev)
    msg = torch.from_numpy(
        rng.integers(0, 2, (3, imgs[0].numel() // 2)).astype(np.uint8)).to(dev)
    base = torch.tensor([0, 5, 11], **i32)
    for t in (2, 47):
        for parity in (0, 1):
            for want in (torch.tensor([0, 700, 5000], **i32),
                         torch.full((3,), 1 << 30, **i32)):
                got = pk.pee_embed(imgs, msg, base, want, parity, t, 4095)
                torch.cuda.synchronize()
                ref = pk.pee_embed_plain(imgs, msg, base, want, parity, t,
                                         4095)
                err = max_abs_diff(got, ref)
                max_err["pee_embed"] = max(max_err["pee_embed"], err)
                check(err == 0, f"K3 != plain on uint8 max_val 4095 T={t} "
                                f"parity={parity} want={want.tolist()}")
                stego, over, _, nproc, _ = got
                gx = pk.pee_extract(stego, over, nproc, parity, t, 8192)
                torch.cuda.synchronize()
                rx = pk.pee_extract_plain(stego, over, nproc, parity, t, 8192)
                err = max_abs_diff(gx, rx)
                max_err["pee_extract"] = max(max_err["pee_extract"], err)
                check(err == 0, f"K4 != plain on uint8 max_val 4095 T={t} "
                                f"parity={parity}")


def k4_case(stego, over, nproc, parity, t, out_len, what):
    """K4 once against its plain version, all three outputs exact. Returns
    K4's outputs."""
    import torch
    from codec_tcc_tpu_torch.ops import pee_kernels as pk

    got = pk.pee_extract(stego, over, nproc, parity, t, out_len)
    torch.cuda.synchronize()
    ref = pk.pee_extract_plain(stego, over, nproc, parity, t, out_len)
    check(max_abs_diff(got, ref) == 0, f"K4 != plain on {what}")
    return got


def k3_stress_case(imgs, msg, base, want, parity, t, max_val, what):
    """K3 once against its plain version (all five outputs exact), and K4
    inverting its output, exact against its plain version and restoring the
    image. Returns K3's outputs."""
    import torch
    from codec_tcc_tpu_torch.ops import pee_kernels as pk

    got = pk.pee_embed(imgs, msg, base, want, parity, t, max_val)
    torch.cuda.synchronize()
    ref = pk.pee_embed_plain(imgs, msg, base, want, parity, t, max_val)
    check(max_abs_diff(got, ref) == 0, f"K3 != plain on {what}")
    restored = k4_case(got[0], got[1], got[3], parity, t, 8, what)[0]
    check(torch.equal(restored, imgs), f"K4 did not restore {what}")
    return got


def phase2_pee_stress(dev) -> str:
    """The look-back stress cases of ``tests/torch_pee_stress.py``: K3 at
    wants at and beside the tile boundaries, 0, 1, cap and cap + 1, narrow
    and wide images, unaligned batches, each inverted by K4; K4 on the
    carrier at cap with ``out_len`` and ``nproc`` at and beside its tile
    boundaries, and on forged inputs; then the many-tile launch of each, 20
    times, every output identical."""
    import torch
    import torch_pee_stress as stress
    from codec_tcc_tpu_torch.ops import kernel_library
    from codec_tcc_tpu_torch.ops import pee_kernels as pk

    tile_px = kernel_library.library().pee_tile_pixels()
    n_k3 = n_k4 = 0
    for shape in stress.SHAPES:
        name, b, h, w, _, max_val = shape
        imgs, msg, base = (torch.from_numpy(a).to(dev)
                           for a in stress.inputs(shape))
        for t in stress.T_VALUES:
            for parity in (0, 1):
                wants = stress.wants(imgs, parity, t, max_val, tile_px)
                for label, want in wants:
                    got = k3_stress_case(imgs, msg, base, want, parity, t,
                                         max_val, f"{name} T={t} parity="
                                         f"{parity} want={label} "
                                         f"{want.tolist()}")
                    n_k3 += 1
                    if label == "cap":
                        carrier = got
                if t != 2:
                    continue
                stego, over, used, nproc, _ = carrier
                for label, np_, out_len in stress.extract_cases(
                        wants, used, nproc, h, w):
                    k4_case(stego, over, np_, parity, t, out_len,
                            f"{name} T={t} parity={parity} {label}")
                    n_k4 += 1
        for parity in (0, 1):
            stego, over = (torch.from_numpy(a).to(dev)
                           for a in stress.forged(shape, 2))
            for label, np_ in stress.set_rank_nprocs(h, w, parity, tile_px):
                k4_case(stego, over, torch.full((b,), np_, dtype=torch.int32,
                                                device=dev),
                        parity, 2, h * w // 2 + 1,
                        f"forged {name} parity={parity} nproc={label}")
                n_k4 += 1
    shape = stress.MANY_TILES
    imgs, msg, base = (torch.from_numpy(a).to(dev)
                       for a in stress.inputs(shape))
    t, parity, max_val = 2, 0, shape[5]
    out_len = imgs[0].numel() // 2 + 1
    cases = dict(stress.wants(imgs, parity, t, max_val, tile_px))
    for label in ("cap", f"tile{-(-imgs[0].numel() // tile_px) // 2}+0"):
        first = k3_stress_case(imgs, msg, base, cases[label], parity, t,
                               max_val, f"{shape[0]} want={label}")
        n_k3 += 1
        stego, over, _, nproc, _ = first
        first_x = k4_case(stego, over, nproc, parity, t, out_len,
                          f"{shape[0]} want={label} all bits")
        n_k4 += 1
        for rep in range(20):
            again = pk.pee_embed(imgs, msg, base, cases[label], parity, t,
                                 max_val)
            check(all(torch.equal(a, b) for a, b in zip(again, first)),
                  f"K3 repeat {rep} on {shape[0]} want={label} differs: a "
                  f"race in the look-back")
            again = pk.pee_extract(stego, over, nproc, parity, t, out_len)
            check(all(torch.equal(a, b) for a, b in zip(again, first_x)),
                  f"K4 repeat {rep} on {shape[0]} want={label} differs: a "
                  f"race in the look-back")
    return (f"look-back stress (tile {tile_px} px): K3 {n_k3} cases exact, "
            f"each inverted by K4 exactly; K4 {n_k4} more cases exact "
            f"(out_len and nproc at tile boundaries, forged inputs); 2 x 20 "
            f"identical repeats of each on {shape[0]}")


def phase2_block(port, dev) -> str:
    """The device block extract (``extract_block_message_device``, torch
    ops on the card) against ``extract_block_host`` on the stegos of the
    ``blk_*`` cases, encoded on the card: the case's own plan and out_len,
    then the same plan with the cut point one lower (the last plane's
    window, past s, must come back as zeros) at out_len 37 and 1024."""
    import numpy as np
    import torch
    import torch_port_cases as cases
    from codec_tcc_tpu_torch import pipeline
    from codec_tcc_tpu_torch.io.container import parse_block_ext
    from codec_tcc_tpu_torch.ops import blocks as block_ops
    from codec_tcc_tpu_torch.ops import embed as embed_ops
    from codec_tcc_tpu_torch.ops import host_extract

    count = 0
    for case in cases.CASES:
        if case.strategy != "block_adaptive":
            continue
        img, s, bits = case_payload(case)
        res = port.encode_array(img, bits, case.config(port.EncodeConfig),
                                bits_stored=case.bits_stored, device="cuda")
        meta = res.meta
        h, w = img.shape
        block = parse_block_ext(meta.ext)
        kbits = pipeline._plane_bucket(s, 8 * img.itemsize)
        _, lens, offs = pipeline._plane_plan_from_meta(meta, img.size, kbits)
        # the decoder's view: bases and rankings from the original's planes
        bases = block_ops.block_bases(torch.from_numpy(img), s, kbits, block)
        counts = host_extract.block_counts_host(img, s, block)
        rankings = [block_ops.ranking_from_counts(counts[p], h, w, block)
                    for p in range(s)]
        stego_d = torch.from_numpy(res.stego).to(dev)
        for cut, out_len in ((s, bits.size), (s - 1, 37), (s - 1, 1024)):
            got = embed_ops.extract_block_message_device(
                stego_d, bases, lens, offs, cut, kbits, block, max(out_len, 1))
            torch.cuda.synchronize()
            want = host_extract.extract_block_host(
                res.stego, rankings, lens, offs, cut, block, max(out_len, 1))
            check(np.array_equal(got.cpu().numpy(), want),
                  f"device block extract != extract_block_host on "
                  f"{case.name} (s={cut}, out_len={out_len})")
            if cut == s:
                check(np.array_equal(want[: bits.size], bits),
                      f"{case.name}: block extract lost the payload")
            count += 1
    return (f"device block extract == extract_block_host on {count} plans "
            f"of the blk_* stegos")


DEFLATE_SHAPES = ((512, 512), (2048, 2048))   # the single cells' images


def phase2_deflate(dev) -> str:
    """The deflate kernels (``ops/deflate_rle.py::encode_device``) against
    their plain version (``encode_plain``) and host zlib (the ``deflate``
    codec's encode), byte for byte: the CPU corpus of
    ``tests/torch_deflate_cases.py``, the probe's images, and the
    benchmark's phantoms at the main path's shapes, 512x512 and 2048x2048
    uint16; the 2048x2048 phantom 5 times, identical. The probe runs here
    first, so the main path's counts leave it out."""
    import zlib

    import torch
    import torch_deflate_cases as dc
    from codec_tcc_tpu_torch.io.codecs import get as get_codec
    from codec_tcc_tpu_torch.ops import deflate_rle as dfl

    t0 = time.perf_counter()
    dfl.check_device_route(dev)
    probe_ms = (time.perf_counter() - t0) * 1e3
    codec = get_codec("deflate")
    images = [(name, dc.case(name)) for name in dc.NAMES]
    images += [(f"probe_{k}", img) for k, img in enumerate(dfl.probe_images())]
    images += [(f"phantom_{h}x{w}", dc.phantom(h, w))
               for h, w in DEFLATE_SHAPES]
    sizes = {}
    for name, img in images:
        t = torch.from_numpy(img).to(dev)
        got = dfl.encode_device(t)
        check(got == dfl.encode_plain(img),
              f"deflate kernels != encode_plain on {name}")
        check(got == codec.encode(img),
              f"deflate kernels != host zlib {zlib.ZLIB_RUNTIME_VERSION} on "
              f"{name}")
        if name.startswith("phantom_"):
            sizes[name] = len(got)
            if name.endswith("2048x2048"):
                check({dfl.encode_device(t) for _ in range(5)} == {got},
                      f"deflate kernels repeat differently on {name}")
    return (f"deflate kernels == encode_plain == host zlib "
            f"{zlib.ZLIB_RUNTIME_VERSION} on {len(images)} images (the "
            f"corpus, the probe, phantoms {sizes} B), 5 repeats identical; "
            f"the probe took {probe_ms:.1f} ms")


def time_deflate(smi, dev) -> dict:
    """The deflate kernels on the phantoms at the main path's shapes: each
    launch's device time (``torch.profiler``), the per-call wall of
    ``encode_device`` (launches, length read-back and the stream's D2H;
    CUDA events) beside host zlib's encode of the same image, and each
    launch's bound from the bytes it must move: tokens and emit read the
    image, emit writes the stream, the tokens' per-block symbol counts are
    written once and read by trees (whose serial heap no byte count
    bounds)."""
    import torch
    import torch_deflate_cases as dc
    from codec_tcc_tpu_torch.io.codecs import get as get_codec
    from codec_tcc_tpu_torch.ops import deflate_rle as dfl

    codec = get_codec("deflate")
    timing = {}
    for h, w in DEFLATE_SHAPES:
        img = dc.phantom(h, w)
        t = torch.from_numpy(img).to(dev)
        nbytes = img.nbytes
        stream = len(dfl.encode_device(t))
        blocks = -(-nbytes // dfl.BLOCK_TOKENS) + 1   # at most: 1 token a byte
        counts = blocks * (dfl.L_CODES + dfl.D_CODES) * 4
        ops = dict(device_ops_ms(lambda: dfl.queue_device(t)))
        per_call = cuda_median_ms(lambda: dfl.encode_device(t))
        walls = []
        for _ in range(5):
            t0 = time.perf_counter()
            codec.encode(img)
            walls.append((time.perf_counter() - t0) * 1e3)
        zlib_ms = statistics.median(walls)
        row = {}
        for name, work in (("deflate_rle_tokens", nbytes + counts),
                           ("deflate_rle_trees", counts),
                           ("deflate_rle_emit", nbytes + stream)):
            row[name] = {"ms": ops.get(name + "_kernel"), "per_call": per_call,
                         "bound": bound(work, 0), "library_ms": zlib_ms}
        timing[f"{h}x{w}"] = row
        dev_txt = ", ".join(
            f"{k} {fmt_ms(v['ms'])} (bound {v['bound'][0]:.5f} ms)"
            for k, v in row.items())
        other = ", ".join(f"{k} {v:.4f} ms" for k, v in ops.items()
                          if not k.startswith("deflate_rle"))
        print(f"  deflate {h}x{w} u16 ({stream} B stream): device {dev_txt}; "
              f"other device ops: {other}; encode_device per call "
              f"{per_call:.4f} ms, host zlib {zlib_ms:.4f} ms (median of 5) "
              f"on {smi}", flush=True)
    return timing


def phase2_inflate(dev) -> tuple:
    """The inflate kernels (``ops/inflate.py::inflate_device``) against host
    zlib (the ``deflate`` codec's decode): the payloads of
    ``tests/torch_inflate_cases.py`` that the card must decode (the corpus,
    uint8, stored blocks only, one block, fixed-code blocks, more blocks
    than the emit's grid, more candidates than the measure takes, each
    with the plain version's counts of candidates, chain blocks and serial
    blocks) and the benchmark's phantoms at 512x512 and 2048x2048 uint16 on
    three seeds each (no serial block), each call one launch of each
    kernel; the 2048x2048 one 5 times, identical; then the payloads the
    host must decode or refuse, with the plain version's status and the
    host's result or message word for word. Returns (text, the largest
    |card - zlib| over every pixel of every payload)."""
    import numpy as np
    import torch
    import torch_inflate_cases as ic
    import torch_inflate_plain as plain
    from codec_tcc_tpu_torch import profiling
    from codec_tcc_tpu_torch.io.codecs import get as get_codec
    from codec_tcc_tpu_torch.ops import inflate as inf

    def spec(blob):
        code, h, w = inf.sdfl_fields(blob)
        cap = inf.limits(len(blob) - inf.SDFL_HEADER,
                         h * w * (2 if code == 3 else 1))[0]
        return plain.inflate_plain(blob, cap), cap

    codec = get_codec("deflate")
    payloads = [(name, ic.payload(name)) for name in ic.DEVICE]
    payloads += [(f"phantom_{h}x{w}_seed{seed}", ic.phantom_payload(h, w,
                                                                    seed))
                 for h, w in ic.PHANTOM_SHAPES for seed in ic.PHANTOM_SEEDS]
    counts, max_err = {}, 0
    for name, blob in payloads:
        before = profiling.launches(inf.KERNELS)
        res = inf.inflate_device(blob, dev)
        after = profiling.launches(inf.KERNELS)
        check(all(after[k] - before[k] == 1 for k in inf.KERNELS),
              f"inflate launches on {name}: {before} -> {after}")
        check(res.status == inf.OK, f"inflate status {res.status} "
              f"({inf.STATUS.get(res.status)}) on {name}")
        want = codec.decode(blob)
        got_img = res.stego.cpu().numpy()
        check(got_img.shape == want.shape and got_img.dtype == want.dtype,
              f"inflate image {got_img.shape} {got_img.dtype} on {name}")
        err = int(np.abs(got_img.astype(np.int64)
                         - want.astype(np.int64)).max())
        max_err = max(max_err, err)
        check(err == 0, f"inflate kernels != host zlib on {name} "
              f"(max abs err {err})")
        got = (res.candidates, res.blocks, res.serial)
        if name.startswith("phantom_"):
            check(res.serial == 0, f"serial blocks {got} on {name}")
            counts[name] = got
            if name.startswith("phantom_2048x2048_seed7"):
                outs = {inf.inflate_device(blob, dev).stego.cpu().numpy()
                        .tobytes() for _ in range(5)}
                check(len(outs) == 1, f"inflate repeats differently on {name}")
        else:
            ref, cap = spec(blob)
            # past the cap the scan keeps candidates in no fixed order: the
            # plain version keeps the first, so its serial count is the most
            serial_ok = (res.serial == ref.serial if ref.candidates <= cap
                         else res.serial <= ref.serial)
            check(got[:2] == (ref.candidates, ref.blocks) and serial_ok,
                  f"inflate counts {got} != plain {ref[2:]} on {name}")
            if name.startswith("fixed_code"):
                check(res.serial > 0, f"no serial block on {name}")
    routed = {}
    for name in ic.HOST:
        blob = ic.payload(name)
        try:
            want, err = codec.decode(blob), None
        except ValueError as exc:
            want, err = None, str(exc)
        if inf.device_route(codec, blob, dev):
            res = inf.inflate_device(blob, dev)
            ref = spec(blob)[0]
            check(res.status != inf.OK and res.status == ref.status,
                  f"inflate status {res.status} (plain {ref.status}) on "
                  f"{name}")
            routed[name] = inf.STATUS[res.status]
        else:
            routed[name] = "not taken"
        try:
            got, got_dev = inf.transport_decode(codec, blob, dev)
            check(err is None and got_dev is None
                  and np.array_equal(got, want),
                  f"host route of {name} gave another result")
        except ValueError as exc:
            check(str(exc) == err, f"host route of {name} raised {exc!r}, "
                  f"not {err!r}")
    torch.cuda.synchronize()
    return (f"inflate kernels == host zlib on {len(payloads)} payloads "
            f"(phantoms' candidates, blocks, serial: {counts}), 5 repeats "
            f"identical; host route: {routed}"), max_err


def inflate_bytes(blob) -> dict:
    """The bytes each inflate kernel must move on a payload, for its bound:
    the scan and the measure read the stream once (the measure's
    candidates cover it), the chain reads each block's header (a dynamic
    block's header up to its first data bit, a stored block's LEN/NLEN)
    and, per chain block, one 56-byte candidate record and one 28-byte
    block record it writes, and the emit reads the stream and writes the
    image once."""
    import torch_inflate_plain as plain
    from codec_tcc_tpu_torch.ops import inflate as inf

    code, h, w = inf.sdfl_fields(blob)
    want = h * w * (2 if code == 3 else 1)
    stream = bytes(blob[inf.SDFL_HEADER:])
    r = plain._Bits(stream)
    p, headers, nblocks = 16, 0, 0
    while True:
        final, btype = r.get(p, 1), r.get(p + 1, 2)
        nblocks += 1
        if btype == 0:
            q = (p + 3 + 7) & ~7
            headers += 5
            p = 8 * (q // 8 + 4 + r.get(q, 16))
        else:
            t = (plain._fixed_tables(p) if btype == 1
                 else plain.dynamic_header(r, p))
            headers += (t.data_bit - p + 7) // 8
            p = plain.decode_block(r, t, want).end
        if final:
            break
    return {"inflate_scan": len(stream), "inflate_measure": len(stream),
            "inflate_chain": headers + nblocks * (56 + 28),
            "inflate_emit": len(stream) + want}


def time_inflate(smi, dev) -> dict:
    """The inflate kernels on the phantoms at the main path's shapes: each
    launch's device time (``torch.profiler``), the device time of one
    ``inflate_device`` call (the stream's upload, the four launches and the
    status read-back; CUDA events), the host's share of a call (the call
    itself, and the stego's download), the per-call wall of
    ``inflate_device`` and of ``transport_decode`` beside host zlib's
    decode of the same payload, and each kernel's bound from the bytes it
    must move (:func:`inflate_bytes`)."""
    import torch
    import torch_inflate_cases as ic
    from codec_tcc_tpu_torch.device import download
    from codec_tcc_tpu_torch.io.codecs import get as get_codec
    from codec_tcc_tpu_torch.ops import inflate as inf

    codec = get_codec("deflate")
    timing = {}

    def walls(fn, reps=REPS):
        fn()
        torch.cuda.synchronize()
        out = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(out)

    for h, w in ic.PHANTOM_SHAPES:
        blob = ic.phantom_payload(h, w, ic.PHANTOM_SEEDS[0])
        work = inflate_bytes(blob)
        ops = dict(device_ops_ms(lambda: inf.inflate_device(blob, dev)))
        device = cuda_median_ms(lambda: inf.inflate_device(blob, dev))
        parts = {"inflate_device": [], "download": []}
        for _ in range(REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = inf.inflate_device(blob, dev)
            t1 = time.perf_counter()
            download(res.stego)
            t2 = time.perf_counter()
            for key, v in zip(parts, (t1 - t0, t2 - t1)):
                parts[key].append(v * 1e3)
        parts = {k: statistics.median(v) for k, v in parts.items()}
        per_call = walls(lambda: inf.inflate_device(blob, dev))
        decode = walls(lambda: inf.transport_decode(codec, blob, dev))
        zlib_ms = walls(lambda: codec.decode(blob))
        row = {k: {"ms": ops.get(k + "_kernel"), "per_call": per_call,
                   "decode": decode, "bound": bound(work[k], 0),
                   "bytes": work[k], "library_ms": zlib_ms}
               for k in inf.KERNELS}
        timing[f"{h}x{w}"] = row
        dev_txt = ", ".join(
            f"{k} {fmt_ms(v['ms'])} (bound {v['bound'][0]:.5f} ms, "
            f"{v['bytes']} B)" for k, v in row.items())
        other = ", ".join(f"{k} {v:.4f} ms" for k, v in ops.items()
                          if not k.startswith("inflate_"))
        part_txt = ", ".join(f"{k} {v:.4f} ms" for k, v in parts.items())
        print(f"  inflate {h}x{w} u16 ({len(blob)} B payload): device "
              f"{dev_txt}; other device ops: {other}; a call's device time "
              f"{device:.4f} ms; host walls: {part_txt}; inflate_device per "
              f"call {per_call:.4f} ms, transport_decode {decode:.4f} ms, "
              f"host zlib decode {zlib_ms:.4f} ms (medians of {REPS}) on "
              f"{smi}", flush=True)
    return timing


def case_path(port, case) -> str:
    """The counted path a parity case runs on: ``pee``, ``block``, ``host``
    (the config routes the raster embed to the host) or ``raster``."""
    if case.strategy == "pee":
        return "pee"
    if case.strategy == "block_adaptive":
        return "block"
    cfg = case.config(port.EncodeConfig)
    return "host" if cfg.resolve_host_route(case.height * case.width) \
        else "raster"


def case_payload(case, dev="cuda"):
    from codec_tcc_tpu_torch.ops.decompose import decompose
    from codec_tcc_tpu_torch.ops.segments import usable_capacity_bits
    import torch
    import torch_port_cases as cases

    img = cases.image(case)
    if case.strategy == "pee":
        return img, 0, cases.payload_bits(case, 0)
    s = decompose(torch.from_numpy(img).to(dev), 0.4, case.bits_stored).s
    return img, s, cases.payload_bits(case, usable_capacity_bits(s, img.size,
                                                                 42))


def pee_start_thresholds(imgs, nbits, bits_stored, cfg, dev):
    """The T each image's first PEE attempt uses (the encoders' histogram
    choice), to work out the K3 launches a path must make."""
    import torch
    from codec_tcc_tpu_torch.models.pee import max_value
    from codec_tcc_tpu_torch.parallel import batch_pee

    dtype_bits = imgs.dtype.itemsize * 8
    eff = bits_stored if cfg.use_bits_stored else dtype_bits
    return batch_pee._start_thresholds(
        torch.from_numpy(imgs).to(dev), nbits,
        max_value(int(imgs.max()), dtype_bits, eff), cfg.pee_threshold)


def phase3_batch(port, results, parity, counted, dev):
    """encode_pee_batch/decode_pee_batch on the four 512x512 uint16 case
    images: every container equals the single-image one (and, for the PEE
    cases, the JAX package's). Returns the text for phase 3 and the
    launches the batch path must make."""
    import numpy as np
    import torch_port_cases as cases
    from codec_tcc_tpu_torch.parallel import batch_pee

    names = ("mr512_u16", "mr512_u16_full", "pee_mr512_u16_text",
             "pee_mr512_u16_100k")
    rng = np.random.default_rng(512)
    imgs, pays = [], []
    for name in names:
        img, _, bits = results[name][:3]
        if not name.startswith("pee_"):
            bits = (bits if bits.size < 1000
                    else rng.integers(0, 2, 20000, dtype=np.uint8))
        imgs.append(img)
        pays.append(bits)
    imgs = np.stack(imgs)
    cfg = port.EncodeConfig(strategy="pee")
    wants = [parity[name]["container_sha256"] if name.startswith("pee_")
             else cases.sha256(port.encode_array(
                 img, bits, cfg, bits_stored=12, device="cuda").container)
             for name, img, bits in zip(names, imgs, pays)]

    def batch_path():
        res = batch_pee.encode_pee_batch(imgs, pays, cfg, bits_stored=12,
                                         device="cuda")
        return res, batch_pee.decode_pee_batch(res.containers, device="cuda")

    res, decs = counted("pee_batch", batch_path)
    check(len(set(res.thresholds.tolist())) > 1,
          f"batch thresholds not mixed: {res.thresholds.tolist()}")
    for name, blob, want in zip(names, res.containers, wants):
        check(cases.sha256(blob) == want,
              f"batch container of {name} differs from the single-image one")
    for name, img, bits, dec in zip(names, imgs, pays, decs):
        check(np.array_equal(dec.payload_bits, bits),
              f"batch decode of {name}: payload differs")
        check(np.array_equal(dec.original, img),
              f"batch decode of {name}: original differs")
    t_start = pee_start_thresholds(imgs, [p.size for p in pays], 12, cfg, dev)
    expected = {"raster_embed": 0, "raster_extract": 0,
                "pee_embed": 2 * cases.pee_attempt_groups(t_start,
                                                          res.thresholds),
                "pee_extract": 2 * len(set(res.thresholds.tolist()))}
    return (f"T={res.thresholds.tolist()} from {t_start.tolist()}",
            expected)


def batch_inputs(names, b, h, w, seed):
    """A batch whose first images are the parity cases ``names`` with their
    payloads and the rest seeded phantoms of the same geometry with the
    304-bit text payload."""
    import numpy as np
    import torch_port_cases as cases

    imgs, pays = [], []
    for name in names:
        img, _, bits = case_payload(cases.BY_NAME[name])
        imgs.append(img)
        pays.append(bits)
    for i in range(len(names), b):
        imgs.append(cases.image(cases.Case(f"batch{i}", h, w, "uint16", 12,
                                           "text", "hybrid", seed + i)))
        pays.append(cases.payload_bits(cases.BY_NAME["mr512_u16"], 0))
    return np.stack(imgs), pays


def phase3_raster_batch(port, parity, counted, launches):
    """The container batch path on the card: ``encode_batch_containers``
    for B = 32 x 512x512 and B = 8 x 2048x2048 uint16 (hybrid, the default
    config: the device route, one K1 launch per batch), a host-route batch
    (``device_policy="host"``: no launch) and a block_adaptive batch (torch
    ops, no launch); every container equal to the single-image
    ``encode_array`` container on the card and, for the parity cases in
    the batch, to the JAX package's; ``extract_batch`` on each device batch
    (one K2 launch) gives the payloads back; ``decode_batch_containers``
    over all of them mixed (raster on the host, block in torch ops: no
    launch) gives the payloads and
    originals back. Returns (text for phase 3, the launches each path must
    make, the device batches for phase 7)."""
    import numpy as np
    import torch_port_cases as cases
    from codec_tcc_tpu_torch.parallel import batch as tb

    runs = (
        ("batch_512", ("mr512_u16", "mr512_u16_full"), 32, 512,
         port.EncodeConfig()),
        ("batch_2048", ("cr2048_u16_full",), 8, 2048, port.EncodeConfig()),
        ("batch_host_512", ("host_mr512_u16",), 32, 512,
         port.EncodeConfig(device_policy="host")),
        ("batch_block_512", ("blk_mr512_u16", "blk_mr512_u16_full"), 4, 512,
         port.EncodeConfig(strategy="block_adaptive")),
    )
    expected, device_batches, everything = {}, {}, []
    for path, names, b, side, cfg in runs:
        imgs, pays = batch_inputs(names, b, side, side, seed=100 * b)
        singles = [cases.sha256(port.encode_array(
            img, bits, cfg, bits_stored=12, device="cuda").container)
            for img, bits in zip(imgs, pays)]
        res = counted(path, lambda: tb.encode_batch_containers(
            imgs, pays, cfg, bits_stored=12, device="cuda"))
        raster = path in ("batch_512", "batch_2048")
        expected[path] = launches(raster_embed_batch=int(raster))
        for i, blob in enumerate(res.containers):
            check(cases.sha256(blob) == singles[i],
                  f"{path}: container {i} differs from encode_array's")
        for name, blob in zip(names, res.containers):
            check(cases.sha256(blob) == parity[name]["container_sha256"],
                  f"{path}: the container of {name} differs from the JAX "
                  f"package's")
        if raster:
            bits = counted(path.replace("batch", "extract"),
                           lambda: tb.extract_batch(res.stego, res.plan,
                                                    device="cuda"))
            expected[path.replace("batch", "extract")] = launches(
                raster_extract_batch=1)
            for i, want in enumerate(pays):
                check(np.array_equal(bits[i, :want.size], want),
                      f"{path}: extract_batch payload {i} differs")
            device_batches[side] = (imgs, pays, res)
        everything += [(blob, img, bits) for blob, img, bits
                       in zip(res.containers, imgs, pays)]
        print(f"  {path}: B={b} {side}x{side} u16 {cfg.strategy} "
              f"{cfg.device_policy}: containers equal encode_array's and "
              f"the JAX package's for {list(names)}", flush=True)
    order = np.random.default_rng(76).permutation(len(everything))
    mixed = [everything[i] for i in order]
    decs = counted("batch_decode", lambda: tb.decode_batch_containers(
        [m[0] for m in mixed], device="cuda"))
    expected["batch_decode"] = launches()
    for (_, img, bits), dec in zip(mixed, decs):
        check(np.array_equal(dec.payload_bits, bits),
              "batch decode: a payload differs")
        check(np.array_equal(dec.original, img),
              "batch decode: an original differs")
    return (f"container batches {[r[0] for r in runs]} equal to "
            f"encode_array and the JAX package, {len(mixed)} mixed decoded",
            expected, device_batches)


def volume_inputs(vcase, vparity):
    """A volume case's volume and payload, the payload checked against the
    fixture's."""
    import torch_port_cases as cases

    want = vparity[vcase.name]
    vol = cases.volume(vcase)
    bits = cases.volume_payload_bits(vcase, want["lsb_bits"])
    check(cases.sha256(bits) == want["payload_sha256"],
          f"{vcase.name}: payload differs from the fixture's")
    return vol, bits


def volume_pee_expected(res, vol, t_min, dev):
    """The K3 launches a PEE volume encode must make (one successful split:
    2 per equal-T attempt group from the histogram's first T to each
    slice's final T) and the K4 launches its decode must make (2 per
    distinct T)."""
    import numpy as np
    import torch
    import torch_port_cases as cases
    from codec_tcc_tpu_torch.io.container import parse, parse_pee_ext
    from codec_tcc_tpu_torch.parallel import batch_pee

    t_final = [parse_pee_ext(parse(c).meta.ext)[0] for c in res.containers]
    max_val = (1 << (8 * vol.dtype.itemsize)) - 1
    t_start = batch_pee._start_thresholds(
        torch.from_numpy(vol).to(dev), np.asarray(res.slice_bits), max_val,
        t_min)
    return (2 * cases.pee_attempt_groups(t_start, t_final),
            2 * len(set(t_final)))


def check_volume_metrics(tag, got, want) -> None:
    """A volume's quality report against the JAX package's: the counts and
    maxima exactly, the rest (float32 moment sums in another order) within
    rtol 1e-4, the limit of ``tests/test_torch_volume.py``."""
    check(got is not None and got.keys() == want.keys(),
          f"{tag}: volume report keys {None if got is None else sorted(got)}"
          f" != the JAX package's {sorted(want)}")
    for k, v in want.items():
        exact = k in ("changed_pixels", "max_abs_diff", "max_value")
        check(got[k] == v if exact else abs(got[k] - v) <= 1e-4 * abs(v),
              f"{tag}: volume report {k} {got[k]} != the JAX package's {v}")


def phase3_volumes(port, vparity, counted, launches, dev, max_err):
    """The volume path on the card, through ``encode_volume`` +
    ``pack_volume``, ``unpack_volume`` and ``extract_volume``: every STGV
    file equal to the JAX package's (the fixture's sha256), the payload and
    the volume back exactly; batch K1/K2 against their plain versions at
    each raster volume's own plan; the quality report of the
    ``VOLUME_METRICS_CASES`` equal to the JAX package's;
    ``golden_block_volume.stgv``;
    ``capacity_report`` on a 512x512 image and on the 64-slice volume and
    ``analyze_pair`` equal to the fixture's. Returns (text, the launches
    each path must make, the inputs of the walls)."""
    import numpy as np
    import torch
    import torch_port_cases as cases
    from codec_tcc_tpu_torch import pipeline
    from codec_tcc_tpu_torch.ops import raster_kernels as rk
    from codec_tcc_tpu_torch.parallel import batch as tb
    from codec_tcc_tpu_torch.parallel import volume as pv
    from codec_tcc_tpu_torch.pipeline import _next_pow2

    expected, walls = {}, {}
    for vcase in cases.VOLUME_CASES:
        want = vparity[vcase.name]
        vol, bits = volume_inputs(vcase, vparity)
        cfg = vcase.config(port.EncodeConfig)
        tag = vcase.name

        def encode():
            res = pv.encode_volume(vol, bits, cfg, device=dev)
            return res, pv.pack_volume(vol, res, cfg, device=dev)

        res, blob = counted(f"{tag}_encode", encode)
        check(res.s == want["s"] and res.threshold == want["threshold"],
              f"{tag}: s={res.s} T={res.threshold} != the JAX package's "
              f"{want['s']} / {want['threshold']}")
        check(res.slice_bits.tolist() == want["slice_bits"],
              f"{tag}: the payload split differs from the JAX package's")
        check(cases.sha256(blob) == want["stgv_sha256"],
              f"{tag}: STGV differs from the JAX package's")
        if tag in cases.VOLUME_METRICS_CASES:
            check_volume_metrics(tag, res.metrics, vparity[f"metrics_{tag}"])
        payload, _, original = counted(
            f"{tag}_unpack", lambda: pv.unpack_volume(blob, device=dev))
        check(np.array_equal(payload, bits), f"{tag}: unpacked payload differs")
        check(original is not None and np.array_equal(original, vol),
              f"{tag}: restored volume differs")
        if vcase.strategy == "pee":
            k3, k4 = volume_pee_expected(res, vol, cfg.pee_threshold, dev)
            expected[f"{tag}_encode"] = launches(pee_embed=k3)
            expected[f"{tag}_unpack"] = launches(pee_extract=k4)
        else:
            raster = vcase.strategy != "block_adaptive"
            expected[f"{tag}_encode"] = launches(
                raster_embed_batch=int(raster))
            # raster slices decode on the host, block slices in torch ops
            expected[f"{tag}_unpack"] = launches()
        if vcase.strategy in ("hybrid", "multi_plane"):
            got = counted(f"{tag}_extract", lambda: pv.extract_volume(
                res.stego, res.plan, device=dev))
            expected[f"{tag}_extract"] = launches(raster_extract_batch=1)
            check(np.array_equal(got, bits),
                  f"{tag}: extract_volume payload differs")
            # the batch kernels at this volume's own plan, beside their
            # plain versions (outside the counted windows)
            plan = res.plan
            vol_d = torch.from_numpy(vol).to(dev)
            msgs = torch.from_numpy(np.ascontiguousarray(
                tb._msg_prefix(plan))).to(dev)
            args = (plan.starts, plan.lengths, plan.offsets, plan.s)
            emit = vol[0].size % 8 == 0
            k = rk.raster_embed_batch(vol_d, msgs, *args, emit_maps=emit,
                                      max_s=res.s)
            torch.cuda.synchronize()
            p = rk.raster_embed_batch_plain(vol_d, msgs, *args,
                                            emit_maps=emit, max_s=res.s)
            e = max_abs_diff(k, p)
            max_err["raster_embed_batch"] = max(
                max_err["raster_embed_batch"], e)
            check(e == 0, f"{tag}: batch K1 != plain at the volume plan")
            out_len = _next_pow2(int(plan.payload_bits.max()))
            k = rk.raster_extract_batch(k[0], *args, out_len)
            torch.cuda.synchronize()
            p = rk.raster_extract_batch_plain(p[0], *args, out_len)
            e = max_abs_diff((k,), (p,))
            max_err["raster_extract_batch"] = max(
                max_err["raster_extract_batch"], e)
            check(e == 0, f"{tag}: batch K2 != plain at the volume plan")
            del vol_d, msgs, k, p
        walls[tag] = (vol, bits, cfg, res, blob)
        print(f"  {tag}: {vcase.depth}x{vcase.height}x{vcase.width} "
              f"{vcase.dtype} {vcase.strategy} s={res.s} T={res.threshold} "
              f"payload={bits.size} bits STGV={len(blob)} B sha256 ok, "
              f"unpack ok", flush=True)

    # the committed golden block_adaptive volume (torch ops: no launch)
    data = os.path.join(HERE, "tests", "data")
    with open(os.path.join(data, "golden_block_volume.stgv"), "rb") as f:
        golden = f.read()
    with open(os.path.join(data, "golden_payload.bin"), "rb") as f:
        gbits = np.unpackbits(np.frombuffer(f.read(), np.uint8))[:1200]
    payload, _, original = counted(
        "vol_golden_block", lambda: pv.unpack_volume(golden, device=dev))
    expected["vol_golden_block"] = launches()
    check(np.array_equal(payload, gbits), "golden_block_volume: payload")
    check(np.array_equal(original, np.load(os.path.join(
        data, "golden_block_volume.npy"))), "golden_block_volume: original")

    # capacity_report: the K3 saturated probe, 2 launches each
    for name, source in cases.CAPACITY_CASES:
        if source in cases.BY_NAME:
            case = cases.BY_NAME[source]
            arr, bs = cases.image(case), case.bits_stored
        else:
            arr, bs = cases.volume(cases.VOLUMES_BY_NAME[source]), None
        rep = counted(name, lambda: pipeline.capacity_report(
            arr, bits_stored=bs, device=dev))
        expected[name] = launches(pee_embed=2)
        check(json.loads(json.dumps(rep)) == vparity[name],
              f"{name}: capacity_report {rep} != the JAX package's "
              f"{vparity[name]}")

    # analyze_pair: device moments (data ranges) or float64 host (12/16)
    for name, source, ranges in cases.ANALYZE_CASES:
        case = cases.BY_NAME[source]
        img, _, pay = case_payload(case, dev)
        stego = port.encode_array(img, pay, case.config(port.EncodeConfig),
                                  bits_stored=case.bits_stored,
                                  device=dev).stego
        check(cases.sha256(stego) == vparity[name]["stego_sha256"],
              f"{name}: stego differs from the JAX package's")
        rep = counted(name, lambda: port.analyze_pair(
            img, stego, device=dev, **cases.ANALYZE_RANGES[ranges]))
        expected[name] = launches()
        ref = vparity[name]["report"]
        check(rep.keys() == ref.keys(), f"{name}: report keys differ")
        for k, v in ref.items():
            # float32 moments in another order: rtol 1e-4; the normalised
            # branch is the same float64 numpy code, whose sums may round
            # in the last place on another numpy build: rtol 1e-12
            tol = (1e-12 if ranges == "12_16" else 1e-4) * abs(v)
            check(abs(rep[k] - v) <= tol,
                  f"{name}: {k} {rep[k]} != the JAX package's {v}")
    return (f"{len(cases.VOLUME_CASES)} volumes' STGV byte-identical to the "
            f"JAX package, unpacked and extracted exactly; "
            f"{len(cases.VOLUME_METRICS_CASES)} volume quality reports, "
            f"golden_block_volume decodes; capacity_report and analyze_pair "
            f"equal to the fixture's",
            expected, walls)


def run_cli(tmp, env, args) -> str:
    proc = subprocess.run(
        [sys.executable, "-m", "codec_tcc_tpu_torch", *args],
        cwd=tmp, env=env, capture_output=True, text=True, timeout=300,
    )
    check(proc.returncode == 0,
          f"CLI {args[0]} failed:\n{proc.stdout}\n{proc.stderr}")
    return proc.stdout


def phase5_cli(parity) -> None:
    import numpy as np
    import torch_port_cases as cases
    from codec_tcc_tpu_torch.io import dicom

    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (HERE, env.get("PYTHONPATH")) if p)
    for name, extra in (("mr512_u16", []),
                        ("pee_mr512_u16_text", ["--strategy", "pee"]),
                        ("blk_mr512_u16", ["--strategy", "block_adaptive"]),
                        ("host_mr512_u16", ["--device-policy", "host"])):
        case = cases.BY_NAME[name]
        img = cases.image(case)
        with tempfile.TemporaryDirectory() as tmp:
            dicom.save_image(img, os.path.join(tmp, "in.dcm"),
                             bits_stored=case.bits_stored)
            run_cli(tmp, env, ["encode", "in.dcm", "out.stgc", "--message",
                               cases.TEXT_PAYLOAD, *extra])
            run_cli(tmp, env, ["decode", "out.stgc", "--output-prefix", "dec"])
            with open(os.path.join(tmp, "out.stgc"), "rb") as f:
                check(cases.sha256(f.read())
                      == parity[name]["container_sha256"],
                      f"CLI container ({name}) differs from the JAX package's")
            with open(os.path.join(tmp, "dec_message.txt"),
                      encoding="utf-8") as f:
                check(f.read() == cases.TEXT_PAYLOAD,
                      f"CLI message differs ({name})")
            restored, _ = dicom.load_image(os.path.join(tmp, "dec_original.dcm"))
            check(np.array_equal(restored, img),
                  f"CLI restored pixels differ ({name})")
    # encode-batch (the per-item runner and --fused) and decode-batch
    names = ("mr512_u16", "pee_mr512_u16_text", "host_mr512_u16")
    with tempfile.TemporaryDirectory() as tmp:
        inputs = []
        for name in names:
            case = cases.BY_NAME[name]
            dicom.save_image(cases.image(case), os.path.join(tmp, f"{name}.dcm"),
                             bits_stored=case.bits_stored)
            inputs.append(f"{name}.dcm")
        run_cli(tmp, env, ["encode-batch", *inputs[:1], "--output-dir", "run",
                           "--message", cases.TEXT_PAYLOAD])
        for strategy, name in (("hybrid", "mr512_u16"),
                               ("pee", "pee_mr512_u16_text")):
            out = f"fused_{strategy}"
            run_cli(tmp, env, ["encode-batch", *inputs, "--output-dir", out,
                               "--message", cases.TEXT_PAYLOAD, "--fused",
                               "--strategy", strategy])
            with open(os.path.join(tmp, out, f"{name}.stgc"), "rb") as f:
                check(cases.sha256(f.read())
                      == parity[name]["container_sha256"],
                      f"CLI encode-batch --fused container ({name}) differs "
                      f"from the JAX package's")
            run_cli(tmp, env, ["decode-batch",
                               *[os.path.join(out, f"{n}.stgc")
                                 for n in names],
                               "--output-dir", f"dec_{strategy}"])
            for n in names:
                with open(os.path.join(tmp, f"dec_{strategy}",
                                       f"{n}_message.txt"),
                          encoding="utf-8") as f:
                    check(f.read() == cases.TEXT_PAYLOAD,
                          f"CLI decode-batch message differs ({n})")
                restored, _ = dicom.load_image(os.path.join(
                    tmp, f"dec_{strategy}", f"{n}_original.dcm"))
                check(np.array_equal(restored,
                                     cases.image(cases.BY_NAME[n])),
                      f"CLI decode-batch original differs ({n})")
        with open(os.path.join(tmp, "run", "mr512_u16.stgc"), "rb") as f:
            check(cases.sha256(f.read())
                  == parity["mr512_u16"]["container_sha256"],
                  "CLI encode-batch (runner) container differs from the JAX "
                  "package's")


def phase5_cli_volume(vparity) -> None:
    """encode-volume (default strategy, multi_plane, with the text: the
    fixture's ``vol64_u16_multi_text``) and decode-volume --dicom on the
    64-slice volume, capacity --json on it, analyze (with --windowed-ssim,
    its report held against the JAX CLI's) and analyze-batch on a DICOM
    pair, demo; each a subprocess on the card."""
    import numpy as np
    import torch_port_cases as cases
    from codec_tcc_tpu_torch.io import dicom

    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (HERE, env.get("PYTHONPATH")) if p)
    vol = cases.volume(cases.VOLUMES_BY_NAME["vol64_u16_multi_text"])
    with tempfile.TemporaryDirectory() as tmp:
        np.save(os.path.join(tmp, "vol.npy"), vol)
        run_cli(tmp, env, ["encode-volume", "vol.npy", "--output", "v.stgv",
                           "--message", cases.TEXT_PAYLOAD])
        with open(os.path.join(tmp, "v.stgv"), "rb") as f:
            check(cases.sha256(f.read())
                  == vparity["vol64_u16_multi_text"]["stgv_sha256"],
                  "CLI encode-volume STGV differs from the JAX package's")
        run_cli(tmp, env, ["decode-volume", "v.stgv", "--output-prefix",
                           "dec", "--dicom"])
        with open(os.path.join(tmp, "dec_payload.bin"), "rb") as f:
            check(f.read() == cases.TEXT_PAYLOAD.encode(),
                  "CLI decode-volume payload differs")
        check(np.array_equal(np.load(os.path.join(tmp, "dec_original.npy")),
                             vol), "CLI decode-volume original differs")
        restored, _ = dicom.load_image(os.path.join(tmp, "dec_original.dcm"))
        check(np.array_equal(restored, vol),
              "CLI decode-volume DICOM original differs")
        out = run_cli(tmp, env, ["capacity", "vol.npy", "--json"])
        rep = json.loads(out.strip().splitlines()[-1])
        check(rep == {"input": "vol.npy", **vparity["cap_vol64_u16"]},
              f"CLI capacity --json {rep} differs from the JAX package's")
        cases.cli_analyze_pair(dicom.save_image, tmp)
        out = run_cli(tmp, env, ["analyze", "o.dcm", "s.dcm",
                                 "--windowed-ssim", "--report", "a.json"])
        n = cases.image(cases.BY_NAME["mr512_u16"]).size
        check(f"pixels changed       : {n} (100.000%)" in out,
              f"CLI analyze output differs:\n{out}")
        with open(os.path.join(tmp, "a.json"), encoding="utf-8") as f:
            rep = json.load(f)
        want = vparity[cases.CLI_ANALYZE_CASE]["report"]
        check(rep.keys() == want.keys(),
              f"CLI analyze report keys {sorted(rep)} != {sorted(want)}")
        for k, v in want.items():
            # windowed SSIM: float32 box means in another order, the limits
            # of tests/test_torch_analyze.py (rtol 1e-5, atol 1e-6); the
            # global report: float32 moments, rtol 1e-4
            tol = (1e-5 * abs(v) + 1e-6 if k == "ssim_windowed"
                   else 0 if isinstance(v, str) else 1e-4 * abs(v))
            check(rep[k] == v if isinstance(v, str) else abs(rep[k] - v) <= tol,
                  f"CLI analyze {k} {rep[k]} != the JAX CLI's {v}")
        run_cli(tmp, env, ["analyze-batch", "o.dcm", "s.dcm", "o.dcm",
                           "o.dcm", "--report", "r.json"])
        out = run_cli(tmp, env, ["demo", "--input", "o.dcm", "--output-dir",
                                 "demo"])
        check("original restored    : OK" in out, f"CLI demo:\n{out}")


def cycle_report(label: str, cycle, reps: int) -> None:
    """Warm encode+decode: host wall (median), stage means, busy share and
    the largest device ops."""
    from codec_tcc_tpu_torch.profiling import get_profiler

    cycle()
    profiler = get_profiler()
    profiler.reset()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        cycle()
        walls.append((time.perf_counter() - t0) * 1e3)
    e2e = statistics.median(walls)
    stages = {k: round(v["mean_ms"], 3) for k, v in profiler.report().items()}
    ops = device_ops_ms(cycle, reps=reps)
    busy = sum(ms for _, ms in ops) if ops else None
    busy_txt = ("not measured" if busy is None else
                f"{busy:.4f} ms device time = {100 * busy / e2e:.2f}% busy")
    print(f"  {label} stage means (host wall ms): {stages}")
    print(f"  {label}: {e2e:.2f} ms host wall (median of {reps}), {busy_txt}",
          flush=True)
    print(f"  {label} largest device ops (ms per cycle): "
          + ", ".join(f"{op} {ms:.4f}" for op, ms in ops[:6]), flush=True)


def time_raster(results, dev) -> dict:
    import numpy as np
    import torch
    from codec_tcc_tpu_torch import pipeline
    from codec_tcc_tpu_torch.ops import raster_kernels as rk

    timing = {}
    for name, label in (("mr512_u16_full", "512x512"),
                        ("cr2048_u16_full", "2048x2048")):
        img, _, bits, res = results[name]
        meta = res.meta
        n = img.size
        starts, lens, offs = pipeline._plane_plan_from_meta(
            meta, n, pipeline._plane_bucket(meta.s, 16))
        img_d = torch.from_numpy(img).to(dev)
        msg_d = torch.from_numpy(bits).to(dev)
        out_len = int(meta.payload_bits)
        stego_d = torch.from_numpy(res.stego).to(dev)
        k1 = lambda: rk.raster_embed(img_d, msg_d, starts, lens, offs, meta.s,
                                     emit_maps=True)
        k1p = lambda: rk.raster_embed_plain(img_d, msg_d, starts, lens, offs,
                                            meta.s, emit_maps=True)
        k2 = lambda: rk.raster_extract(stego_d, starts, lens, offs, meta.s,
                                       out_len)
        k2p = lambda: rk.raster_extract_plain(stego_d, starts, lens, offs,
                                              meta.s, out_len)
        row = {k: cuda_median_ms(f) for k, f in
               (("k1", k1), ("k1_plain", k1p), ("k2", k2), ("k2_plain", k2p))}
        dev_row = {k: device_ms(f) for k, f in
                   (("k1", k1), ("k1_plain", k1p), ("k2", k2),
                    ("k2_plain", k2p))}
        # bytes each function must move: K1 reads the image and the message
        # bits once and writes the stego and s packed maps; K2 reads the
        # pixels its windows cover and writes the payload bits
        covered = np.zeros(n, bool)
        for p in range(meta.s):
            span = (int(starts[p]) + np.arange(min(int(lens[p]), n))) % n
            covered[span] = True
        k1_bytes, k1_ops = k1_work(n, img.itemsize, meta.s, lens, out_len)
        k2_bytes = 2 * int(covered.sum()) + out_len
        row["k1_bound"] = bound(k1_bytes, k1_ops)
        row["k2_bound"] = bound(k2_bytes, 3 * out_len)
        row.update({f"dev_{k}": v for k, v in dev_row.items()})
        cold = {k: queued_ms(f, cold=True)
                for k, f in (("k1", k1), ("k2", k2))}
        # yardsticks: one torch copy that moves each kernel's bytes (half
        # read, half written)
        copy_ms = {}
        for key, nbytes in (("k1", k1_bytes), ("k2", k2_bytes)):
            src = torch.zeros(nbytes // 2, dtype=torch.uint8, device=dev)
            dst = torch.empty_like(src)
            copy_ms[key] = device_ms(lambda: dst.copy_(src))
        timing[label] = row
        print(f"  {label} u16 s={meta.s} payload={out_len} bits, per call "
              f"(CUDA events, wrapper included): K1 {row['k1']:.4f} ms "
              f"(plain {row['k1_plain']:.4f} ms), K2 {row['k2']:.4f} ms "
              f"(plain {row['k2_plain']:.4f} ms)")
        print(f"  {label} u16 device time only (profiler): K1 "
              f"{fmt_ms(dev_row['k1'])} (plain {fmt_ms(dev_row['k1_plain'])}),"
              f" K2 {fmt_ms(dev_row['k2'])} "
              f"(plain {fmt_ms(dev_row['k2_plain'])}); bounds K1 "
              f"{row['k1_bound'][0]:.4f} ms ({k1_bytes} B), K2 "
              f"{row['k2_bound'][0]:.4f} ms ({k2_bytes} B)")
        for key, tag, nbytes in (("k1", "K1", k1_bytes),
                                 ("k2", "K2", k2_bytes)):
            share = ("not measured" if dev_row[key] is None else
                     f"{100 * row[key + '_bound'][0] / dev_row[key]:.1f}%")
            print(f"  {label} u16 {tag}: {share} of its bound's rate; a "
                  f"torch copy of the same {nbytes} B takes "
                  f"{fmt_ms(copy_ms[key])} device; queued after a spin "
                  f"with L2 flushed: {cold[key]:.4f} ms", flush=True)
    return timing


def time_pee(results, dev) -> dict:
    """K3/K4 at the 2048x2048 3 Mbit plan, pass by pass."""
    import torch
    from codec_tcc_tpu_torch.io.container import parse_pee_ext
    from codec_tcc_tpu_torch.models.pee import message_buffer
    from codec_tcc_tpu_torch.ops import pee_kernels as pk

    img, _, bits, res = results["pee_cr2048_u16_3m"]
    t = parse_pee_ext(res.meta.ext)[0]
    n = img.size
    max_val = 4095
    i32 = dict(dtype=torch.int32, device=dev)
    img_d = torch.from_numpy(img).to(dev)[None]
    msg_d = message_buffer([bits], dev)
    want = torch.tensor([bits.size], **i32)
    zero = torch.zeros(1, **i32)
    s0, o0, u0, n0, _ = pk.pee_embed(img_d, msg_d, zero, want, 0, t, max_val)
    s1, o1, u1, n1, _ = pk.pee_embed(s0, msg_d, u0, want - u0, 1, t, max_val)
    over = o0 | o1
    out_len = 1 << max(3, (bits.size - 1).bit_length())
    r1 = pk.pee_extract(s1, over, n1, 1, t, out_len)[0]
    used = (int(u0), int(u1))
    calls = {
        "k3_pass0": (lambda: pk.pee_embed(img_d, msg_d, zero, want, 0, t,
                                          max_val),
                     lambda: pk.pee_embed_plain(img_d, msg_d, zero, want, 0,
                                                t, max_val)),
        "k3_pass1": (lambda: pk.pee_embed(s0, msg_d, u0, want - u0, 1, t,
                                          max_val),
                     lambda: pk.pee_embed_plain(s0, msg_d, u0, want - u0, 1,
                                                t, max_val)),
        "k4_pass1": (lambda: pk.pee_extract(s1, over, n1, 1, t, out_len),
                     lambda: pk.pee_extract_plain(s1, over, n1, 1, t,
                                                  out_len)),
        "k4_pass0": (lambda: pk.pee_extract(r1, over, n0, 0, t, out_len),
                     lambda: pk.pee_extract_plain(r1, over, n0, 0, t,
                                                  out_len)),
    }
    timing = {}
    ops = K3_K4_OPS_PER_PIXEL * n
    for key, (kern, plain) in calls.items():
        if key.startswith("k3"):
            # image read, stego and overflow map written, this pass's bits
            nbytes = 2 * n + 2 * n + n + used[int(key[-1])]
        else:
            # stego and overflow map read, restored image and bits written
            nbytes = 2 * n + n + 2 * n + out_len
        row = {"ms": cuda_median_ms(kern), "plain_ms": cuda_median_ms(plain),
               "dev_ms": device_ms(kern), "dev_plain_ms": device_ms(plain),
               "bound": bound(nbytes, ops), "bytes": nbytes}
        timing[key] = row
        print(f"  2048x2048 u16 T={t} {key}: per call {row['ms']:.4f} ms "
              f"(plain {row['plain_ms']:.4f} ms), device "
              f"{fmt_ms(row['dev_ms'])} (plain {fmt_ms(row['dev_plain_ms'])}),"
              f" bound {row['bound'][0]:.4f} ms ({nbytes} B)", flush=True)
    return timing


def device_ops_ms(fn, reps: int = REPS) -> list:
    """(op name, device ms per call of ``fn()``) for every CUDA kernel and
    copy ``torch.profiler`` records over ``reps`` calls, largest first.

    The ``profiling.stage`` ranges also appear on the device side, as
    annotations that span the kernels inside them and the gaps between
    those; they are left out (the cycles' busy shares up to PR 7 summed
    them in)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    ranges = {evt.key for evt in events if evt.device_type == DeviceType.CPU}
    ops = {}
    for evt in events:
        if (evt.device_type == DeviceType.CUDA and evt.self_device_time_total
                and not getattr(evt, "is_user_annotation", False)
                and evt.key not in ranges):
            name = short_op(evt.key)
            ops[name] = ops.get(name, 0.0) + evt.self_device_time_total
    return sorted(((k, v / 1e3 / reps) for k, v in ops.items()),
                  key=lambda kv: -kv[1])


def short_op(name: str) -> str:
    """A CUDA kernel's name without its template arguments and namespaces
    (``void at::native::reduce_kernel<512, ...>(...)`` -> ``reduce_kernel``,
    with the functor for the elementwise ones); copies keep their name."""
    import re

    if name.startswith("Memcpy") or name.startswith("Memset"):
        return name
    base = re.split(r"[<(]", name.replace("void ", "", 1), maxsplit=1)[0]
    base = base.split("::")[-1]
    functors = re.findall(r"\w+Functor\w*|\w+_kernel_cuda|\w+_functor"
                          r"|compare_scalar_kernel", name)
    specific = [f for f in functors if f not in (
        "AUnaryFunctor", "BUnaryFunctor", "BinaryFunctor", "UnaryFunctor")]
    functor = (specific or functors or [None])[0]
    return f"{base}[{functor}]" if functor else base


def time_block(results, dev) -> None:
    """The block encode's device work at ``blk_cr2048_u16_full``, op by op:
    the tile popcounts of s planes, the variance-ranked embed, the packed
    XOR maps and the metric moments; each against the least time the card
    could take for its bytes (what a hand kernel would be ranked by)."""
    from types import SimpleNamespace

    import torch
    from codec_tcc_tpu_torch import pipeline
    from codec_tcc_tpu_torch.io.container import parse_block_ext
    from codec_tcc_tpu_torch.ops import blocks as block_ops
    from codec_tcc_tpu_torch.ops import embed as embed_ops
    from codec_tcc_tpu_torch.ops import metrics as metric_ops

    img, s, bits, res = results["blk_cr2048_u16_full"]
    h, w = img.shape
    n = img.size
    block = parse_block_ext(res.meta.ext)
    kbits = pipeline._plane_bucket(s, 16)
    _, lens, offs = pipeline._plane_plan_from_meta(res.meta, n, kbits)
    img_d = torch.from_numpy(img).to(dev)
    msg_d = torch.from_numpy(bits).to(dev)
    bases = block_ops.block_bases(img_d, s, kbits, block)
    stego_d = embed_ops.embed_block_adaptive(img_d, msg_d, bases, lens, offs,
                                             s, kbits, block)
    check(torch.equal(stego_d.cpu(), torch.from_numpy(res.stego)),
          "blk_cr2048_u16_full: the timed embed differs from the encode's")
    calls = {
        "popcount": lambda: block_ops.block_bit_counts_all(img_d, s, block),
        "embed": lambda: embed_ops.embed_block_adaptive(
            img_d, msg_d, bases, lens, offs, s, kbits, block),
        "maps": lambda: embed_ops.xor_maps_packed_batch(
            img_d[None], stego_d[None], s),
        "pair_stats": lambda: metric_ops.pair_stats(img_d, stego_d),
    }
    # bytes each function must move: image read once (popcount, embed,
    # maps and moments), stego written (embed) or read (maps, moments), the
    # message bytes read (embed), s packed map planes written (maps)
    nbytes = {"popcount": 2 * n, "embed": 2 * n + 2 * n + bits.size,
              "maps": 2 * n + 2 * n + s * n // 8, "pair_stats": 4 * n}
    out = {}
    for key, fn in calls.items():
        out[key] = {"ms": cuda_median_ms(fn), "dev_ms": device_ms(fn),
                    "bytes": nbytes[key], "bound": bound(nbytes[key], 0)}
        print(f"  blk 2048x2048 u16 s={s} {key}: per call "
              f"{out[key]['ms']:.4f} ms, device {fmt_ms(out[key]['dev_ms'])}"
              f", bound {out[key]['bound'][0]:.4f} ms ({nbytes[key]} B)",
              flush=True)
        print(f"    {key} ops (ms device per call): "
              + ", ".join(f"{op} {ms:.4f}" for op, ms in device_ops_ms(fn)))
    # the encode's device work as one function (K5's candidate scope):
    # image read, stego and s map planes written, message bytes read
    k5_bytes = 2 * n + 2 * n + s * n // 8 + bits.size
    total = sum(v["dev_ms"] or 0.0 for k, v in out.items()
                if k in ("embed", "maps"))
    print(f"  blk 2048x2048 u16 embed + maps: {total:.4f} ms device, bound "
          f"{bound(k5_bytes, 0)[0]:.4f} ms ({k5_bytes} B)", flush=True)
    pp = SimpleNamespace(lengths=lens, offsets=offs)
    whole = device_ops_ms(lambda: pipeline._embed_block(
        img_d, bits, pp, s, kbits, block, True, True), reps=5)
    print(f"  blk 2048x2048 u16 encode device work (popcounts, ranking on "
          f"the host, embed, moments, maps, downloads): "
          f"{sum(ms for _, ms in whole):.4f} ms device per encode; ops: "
          + ", ".join(f"{op} {ms:.4f}" for op, ms in whole[:10]), flush=True)


def time_routes(port, results) -> None:
    """Encode host wall, median of 5, with ``compute_metrics=False`` under
    ``device_policy="device"`` (K1) and ``"host"`` (numpy windows), in
    turns; the two containers must be equal."""
    for name in ("mr512_u16_full", "cr2048_u16_full"):
        img, _, bits, _ = results[name]
        walls = {"device": [], "host": []}
        blobs = {}
        for rep in range(6):
            for policy in walls:
                cfg = port.EncodeConfig(compute_metrics=False,
                                        device_policy=policy)
                t0 = time.perf_counter()
                res = port.encode_array(img, bits, cfg, bits_stored=12,
                                        device="cuda")
                if rep:                 # the first round warms up
                    walls[policy].append((time.perf_counter() - t0) * 1e3)
                blobs[policy] = res.container
        check(blobs["device"] == blobs["host"],
              f"{name}: host and device routes gave different containers")
        med = {k: statistics.median(v) for k, v in walls.items()}
        print(f"  {name} encode, compute_metrics=False, host wall median of "
              f"5: device route {med['device']:.2f} ms, host route "
              f"{med['host']:.2f} ms", flush=True)


def time_batch_kernels(device_batches, dev) -> dict:
    """The batch kernels at the container batches' own inputs (B = 32 x
    512x512 and B = 8 x 2048x2048 uint16, their plans and payloads): per
    call (CUDA events, wrapper and table upload included), device time
    (profiler) and device time queued after a spin, warm and with L2
    flushed (:func:`queued_ms`), of one batch launch, of its plain version
    and of B launches of the single-image wrapper on the same inputs, and
    the bound from the bytes each batch must move."""
    import numpy as np
    import torch
    from codec_tcc_tpu_torch.ops import raster_kernels as rk
    from codec_tcc_tpu_torch.parallel import batch as tb
    from codec_tcc_tpu_torch.pipeline import _next_pow2

    timing = {}
    for side, (imgs, pays, res) in sorted(device_batches.items()):
        plan = res.plan
        b, n = imgs.shape[0], imgs[0].size
        max_s = int(plan.s.max())
        imgs_d = torch.from_numpy(imgs).to(dev)
        msgs_d = torch.from_numpy(np.ascontiguousarray(
            tb._msg_prefix(plan))).to(dev)
        stego_d = torch.from_numpy(res.stego).to(dev)
        out_len = _next_pow2(int(plan.payload_bits.max()))
        args = (plan.starts, plan.lengths, plan.offsets, plan.s)
        rows = [(plan.starts[i], plan.lengths[i], plan.offsets[i],
                 int(plan.s[i])) for i in range(b)]

        def singles_k1():
            for i, row in enumerate(rows):
                rk.raster_embed(imgs_d[i], msgs_d[i], *row, emit_maps=True)

        def singles_k2():
            for i, row in enumerate(rows):
                rk.raster_extract(stego_d[i], *row, out_len)

        calls = {
            "k1": lambda: rk.raster_embed_batch(
                imgs_d, msgs_d, *args, emit_maps=True, max_s=max_s),
            "k1_plain": lambda: rk.raster_embed_batch_plain(
                imgs_d, msgs_d, *args, emit_maps=True, max_s=max_s),
            "k1_singles": singles_k1,
            "k2": lambda: rk.raster_extract_batch(stego_d, *args, out_len),
            "k2_plain": lambda: rk.raster_extract_batch_plain(
                stego_d, *args, out_len),
            "k2_singles": singles_k2,
        }
        row = {k: cuda_median_ms(f) for k, f in calls.items()}
        row.update({f"dev_{k}": device_ms(f) for k, f in calls.items()})
        for k in ("k1", "k1_singles", "k2", "k2_singles"):
            row[f"queued_{k}"] = queued_ms(calls[k], cold=False)
            row[f"cold_{k}"] = queued_ms(calls[k], cold=True)
        # bytes: K1 reads every image and its message bits and writes every
        # stego and max_s packed map planes; K2 reads the pixels its
        # windows cover up to out_len and writes B x out_len bits
        k1_bytes = k1_ops = k2_bytes = 0
        for i, (st, ln, of, si) in enumerate(rows):
            nb, ops = k1_work(n, imgs.itemsize, si, ln, pays[i].size)
            k1_bytes += nb + (max_s - si) * n // 8
            k1_ops += ops
            covered = sum(min(int(ln[p]), n, max(out_len - int(of[p]), 0))
                          for p in range(si))
            k2_bytes += imgs.itemsize * covered + out_len
        row["k1_bound"] = bound(k1_bytes, k1_ops)
        row["k2_bound"] = bound(k2_bytes, 3 * b * out_len)
        timing[side] = row
        label = f"B={b} {side}x{side} u16"
        print(f"  {label} batch K1 (maps over {max_s} planes): per call "
              f"{row['k1']:.4f} ms, device {fmt_ms(row['dev_k1'])} (plain "
              f"{row['k1_plain']:.4f} / {fmt_ms(row['dev_k1_plain'])}; {b} "
              f"single-image K1 launches {row['k1_singles']:.4f} / "
              f"{fmt_ms(row['dev_k1_singles'])}), bound "
              f"{row['k1_bound'][0]:.4f} ms ({k1_bytes} B); queued after a "
              f"spin: batch {row['queued_k1']:.4f} ms, singles "
              f"{row['queued_k1_singles']:.4f} ms; the same with L2 "
              f"flushed: batch {row['cold_k1']:.4f} ms, singles "
              f"{row['cold_k1_singles']:.4f} ms", flush=True)
        print(f"  {label} batch K2 (out_len {out_len}): per call "
              f"{row['k2']:.4f} ms, device {fmt_ms(row['dev_k2'])} (plain "
              f"{row['k2_plain']:.4f} / {fmt_ms(row['dev_k2_plain'])}; {b} "
              f"single-image K2 launches {row['k2_singles']:.4f} / "
              f"{fmt_ms(row['dev_k2_singles'])}), bound "
              f"{row['k2_bound'][0]:.4f} ms ({k2_bytes} B); queued after a "
              f"spin: batch {row['queued_k2']:.4f} ms, singles "
              f"{row['queued_k2_singles']:.4f} ms; the same with L2 "
              f"flushed: batch {row['cold_k2']:.4f} ms, singles "
              f"{row['cold_k2_singles']:.4f} ms", flush=True)
    return timing


def time_batch_walls(port, device_batches) -> None:
    """Host walls of ``encode_batch_containers`` (``compute_metrics=False``
    under ``device_policy`` "device" and "host", and the default config:
    "auto" with metrics, which routes to the device) and of
    ``decode_batch_containers`` at B = 32 x 512x512 uint16 with the 304-bit
    payload, in turns, median of 5 after a warm-up round, with the stage
    means of each."""
    import numpy as np
    import torch_port_cases as cases
    from codec_tcc_tpu_torch.parallel import batch as tb
    from codec_tcc_tpu_torch.profiling import get_profiler

    imgs, _ = batch_inputs((), 32, 512, 512, seed=9000)
    text = cases.payload_bits(cases.BY_NAME["mr512_u16"], 0)
    pays = [text] * len(imgs)
    configs = {
        "device": port.EncodeConfig(compute_metrics=False,
                                    device_policy="device"),
        "host": port.EncodeConfig(compute_metrics=False,
                                  device_policy="host"),
        "auto+metrics": port.EncodeConfig(),
    }
    walls = {k: [] for k in list(configs) + ["decode"]}
    stages = {k: {} for k in walls}
    blobs = {}
    profiler = get_profiler()
    for rep in range(6):
        for key, cfg in configs.items():
            profiler.reset()
            t0 = time.perf_counter()
            res = tb.encode_batch_containers(imgs, pays, cfg, bits_stored=12,
                                             device="cuda")
            wall = (time.perf_counter() - t0) * 1e3
            blobs[key] = res.containers
            if rep:
                walls[key].append(wall)
                for name, v in profiler.report().items():
                    stages[key].setdefault(name, []).append(1e3 * v["wall_s"])
        profiler.reset()
        t0 = time.perf_counter()
        decs = tb.decode_batch_containers(blobs["device"], device="cuda")
        wall = (time.perf_counter() - t0) * 1e3
        if rep:
            walls["decode"].append(wall)
            for name, v in profiler.report().items():
                stages["decode"].setdefault(name, []).append(1e3 * v["wall_s"])
    check(blobs["device"] == blobs["host"] == blobs["auto+metrics"],
          "batch walls: the routes gave different containers")
    check(all(np.array_equal(d.original, img) for d, img in zip(decs, imgs)),
          "batch walls: a decoded original differs")
    for key in walls:
        med = statistics.median(walls[key])
        per = {name: round(statistics.median(v), 3)
               for name, v in stages[key].items()}
        what = "decode" if key == "decode" else f"encode {key}"
        print(f"  batch B=32 512x512 u16 304 bits, {what}: "
              f"{med:.2f} ms host wall (median of 5), "
              f"{1e3 * len(imgs) / med:.1f} images/s; stages (ms): {per}",
              flush=True)


def time_volume_walls(walls) -> None:
    """Host walls, median of 3 after a warm-up, with the stage means of
    each, at the 64x512x512 uint16 hybrid volume with half its LSB
    capacity: ``encode_volume`` + ``pack_volume``, ``unpack_volume`` and
    ``extract_volume``."""
    import numpy as np
    from codec_tcc_tpu_torch.parallel import volume as pv
    from codec_tcc_tpu_torch.profiling import get_profiler

    vol, bits, cfg, res, blob = walls["vol64_u16_hybrid_half"]
    calls = {
        "encode_volume + pack_volume": lambda: pv.pack_volume(
            vol, pv.encode_volume(vol, bits, cfg, device="cuda"), cfg,
            device="cuda"),
        "unpack_volume": lambda: pv.unpack_volume(blob, device="cuda"),
        "extract_volume": lambda: pv.extract_volume(res.stego, res.plan,
                                                    device="cuda"),
    }
    profiler = get_profiler()
    for what, fn in calls.items():
        times, stages = [], {}
        for rep in range(4):
            profiler.reset()
            t0 = time.perf_counter()
            out = fn()
            wall = (time.perf_counter() - t0) * 1e3
            if rep:                     # the first call warms up
                times.append(wall)
                for name, v in profiler.report().items():
                    stages.setdefault(name, []).append(1e3 * v["wall_s"])
        if what == "encode_volume + pack_volume":
            check(out == blob, "volume walls: the STGV changed")
        elif what == "extract_volume":
            check(np.array_equal(out, bits), "volume walls: extract differs")
        per = {name: round(statistics.mean(v), 3)
               for name, v in stages.items()}
        med = statistics.median(times)
        print(f"  volume 64x512x512 u16 hybrid, {bits.size} bits, {what}: "
              f"{med:.2f} ms host wall (median of 3; "
              f"{vol.nbytes / med / 1e3:.1f} MB/s of volume); stage means "
              f"(ms): {per}", flush=True)
    time_volume_kernels(vol, bits, res)


def time_volume_kernels(vol, bits, res) -> None:
    """Batch K1 (``encode_batch``: no maps) and batch K2
    (``extract_volume``'s bucketed ``out_len``) at the 64-slice volume's
    own plan: per call (CUDA events, wrapper and table upload included),
    device time (profiler), queued after a spin with L2 flushed, and the
    bound from the bytes each must move."""
    import numpy as np
    import torch
    from codec_tcc_tpu_torch.ops import raster_kernels as rk
    from codec_tcc_tpu_torch.parallel import batch as tb
    from codec_tcc_tpu_torch.pipeline import _next_pow2

    plan = res.plan
    d, n = vol.shape[0], vol[0].size
    vol_d = torch.from_numpy(vol).to("cuda")
    stego_d = torch.from_numpy(res.stego).to("cuda")
    msgs = torch.from_numpy(np.ascontiguousarray(
        tb._msg_prefix(plan))).to("cuda")
    args = (plan.starts, plan.lengths, plan.offsets, plan.s)
    out_len = _next_pow2(int(plan.payload_bits.max()))
    calls = {
        "K1": lambda: rk.raster_embed_batch(vol_d, msgs, *args,
                                            emit_maps=False),
        "K2": lambda: rk.raster_extract_batch(stego_d, *args, out_len),
    }
    # K1 reads every slice and the message bits its windows cover and
    # writes every stego; K2 reads the pixels its windows cover up to
    # out_len and writes D x out_len bits
    k1_bytes = k1_ops = k2_bytes = 0
    for i in range(d):
        si = int(plan.s[i])
        nb, ops = k1_work(n, vol.itemsize, si, plan.lengths[i],
                          int(plan.payload_bits[i]))
        k1_bytes += nb - si * n // 8
        k1_ops += ops - si * n
        covered = sum(min(int(plan.lengths[i][p]), n,
                          max(out_len - int(plan.offsets[i][p]), 0))
                      for p in range(si))
        k2_bytes += vol.itemsize * covered + out_len
    bounds = {"K1": bound(k1_bytes, k1_ops),
              "K2": bound(k2_bytes, 3 * d * out_len)}
    for name, fn in calls.items():
        print(f"  volume 64x512x512 u16 batch {name} at the {bits.size}-bit "
              f"plan: per call {cuda_median_ms(fn):.4f} ms, device "
              f"{fmt_ms(device_ms(fn))}, queued after a spin with L2 "
              f"flushed {queued_ms(fn, cold=True):.4f} ms, bound "
              f"{bounds[name][0]:.4f} ms "
              f"({k1_bytes if name == 'K1' else k2_bytes} B)", flush=True)


def phase2_pee_shard(dev, parity, max_err) -> str:
    """K3/K4's band launches against their plain versions on the card: the
    2048x2048 uint16 image of the 3 Mbit PEE case at its T, split into 4
    bands, pass 0 at the whole payload (saturated) and at half its
    capacity (the boundary inside a band), pass 1 on the saturated pass's
    stego at the rest of the payload; each inverted by K4. Exact: every
    band's tile counts, stego, overflow and nproc (K3's count and apply)
    and tile counts, restored band, valid bits and nbits (K4's count and
    apply); the used count and the pass boundary; the four bands stitched
    together against the whole-image K3/K4. Updates ``max_err``; returns
    the text for phase 2."""
    import torch
    import torch_port_cases as cases
    import torch_tile_cases as tiles
    from codec_tcc_tpu_torch.models.pee import message_buffer
    from codec_tcc_tpu_torch.ops import pee_kernels as pk

    case = cases.BY_NAME[cases.TILED_PEE]
    k, max_val = cases.TILED_BIG_K, (1 << case.bits_stored) - 1
    t = parity[case.name]["pee_ext"][0]
    img = torch.from_numpy(cases.image(case)).to(dev)[None]
    bits = cases.payload_bits(case, 0)
    total = bits.size
    msg = message_buffer([bits], dev)
    out_len = 1 << max(3, (total - 1).bit_length())

    def i32(v):
        return torch.tensor([int(v)], dtype=torch.int32, device=dev)

    def band_err(got, ref, names):
        """Max abs error of each launch over the bands: per band the count
        launch's output first, then the apply launch's."""
        for name, g, r in ((names[0], [x[:1] for x in got],
                            [x[:1] for x in ref]),
                           (names[1], [x[1:] for x in got],
                            [x[1:] for x in ref])):
            err = max(max_abs_diff(a, b) for a, b in zip(g, r))
            max_err[name] = max(max_err[name], err)
            check(err == 0, f"{name} != plain at {what}")

    cap0 = int(pk.pee_embed(img, msg, i32(0), i32(0), 0, t, max_val)[4][0])
    s0, _, u0, _, _ = pk.pee_embed(img, msg, i32(0), i32(total), 0, t,
                                   max_val)
    used0 = int(u0[0])
    runs = ((img, 0, total, 0), (img, 0, cap0 // 2, 0),
            (s0, used0, total - used0, 1))
    for src, base, want, par in runs:
        what = f"2048x2048 T={t} parity={par} want={want} over {k} bands"
        got, (stego, over, used, nproc) = tiles.embed(
            src, msg, base, want, par, t, max_val, k)
        ref, _ = tiles.embed(src, msg, base, want, par, t, max_val, k,
                             plain=True)
        torch.cuda.synchronize()
        band_err(got, ref, ("pee_count_band", "pee_embed_band"))
        whole = pk.pee_embed(src, msg, i32(base), i32(want), par, t, max_val)
        check(max_abs_diff((stego, over), whole[:2]) == 0
              and (used, nproc) == (int(whole[2][0]), int(whole[3][0]))
              and sum(int(g[0].sum()) for g in got) == int(whole[4][0]),
              f"K3 bands stitched != whole-image K3 at {what}")
        got, (restored, bits_k, n_bits) = tiles.extract(
            stego, over, nproc, par, t, out_len, k)
        ref, _ = tiles.extract(stego, over, nproc, par, t, out_len, k,
                               plain=True)
        torch.cuda.synchronize()
        band_err(got, ref, ("pee_extract_count_band", "pee_extract_band"))
        w_r, w_bits, w_n = pk.pee_extract(stego, over, i32(nproc), par, t,
                                          out_len)
        check(torch.equal(restored, w_r) and torch.equal(restored, src)
              and torch.equal(bits_k, w_bits[0].cpu())
              and n_bits == int(w_n[0]) == used,
              f"K4 bands stitched != whole-image K4 at {what}")
    return (f"K3/K4 band launches (count, apply) == plain at 2048x2048 u16 "
            f"T={t} over {k} bands (pass 0 saturated and at {cap0 // 2}, "
            f"pass 1 at {total - used0}), stitched == whole image")


def phase3_f1(port, tparity, counted, dev):
    """F1: the PEE batch whose escalation embeds a group of three entries
    that holds an image twice (``torch_port_cases.f1_batch``): containers
    equal to the JAX package's (the fixture's ``tiled`` section), each
    decoding to its payload. Returns (text, the launches of the path)."""
    import numpy as np
    import torch
    import torch_port_cases as cases
    from codec_tcc_tpu_torch.models.pee import max_value
    from codec_tcc_tpu_torch.parallel import batch_pee

    imgs, pays = cases.f1_batch()
    cfg = port.EncodeConfig(strategy="pee", pee_threshold=cases.F1_THRESHOLD)
    want = tparity["f1_pee_batch"]

    def f1_path():
        res = batch_pee.encode_pee_batch(imgs, pays, cfg, device=dev)
        return res, batch_pee.decode_pee_batch(res.containers, device=dev)

    res, decs = counted("pee_f1", f1_path)
    check([cases.sha256(c) for c in res.containers]
          == want["container_sha256"],
          "F1 batch: containers differ from the JAX package's")
    for i, dec in enumerate(decs):
        check(np.array_equal(dec.payload_bits, pays[i]),
              f"F1 batch: payload {i} differs")
    t_start = batch_pee._start_thresholds(
        torch.from_numpy(imgs), [p.size for p in pays],
        max_value(int(imgs.max()), 16, 16), cases.F1_THRESHOLD)
    groups = cases.pee_attempt_group_lists(t_start, res.thresholds)
    check(tuple(cases.F1_GROUP) in [(t, i) for t, i in groups],
          f"F1 batch: no duplicate group in {groups}")
    expected = {"pee_embed": 2 * len(groups),
                "pee_extract": 2 * len(set(res.thresholds.tolist()))}
    return (f"F1 batch (groups {groups}) equal to the JAX package's",
            expected)


def phase3_tiled(port, parity, tparity, counted, dev):
    """One image across a mesh of the card repeated K times
    (``make_mesh(devices=["cuda:0"] * K)``): ``encode_array_tiled_pee`` /
    ``decode_container_tiled_pee`` on the 2048x2048 3 Mbit PEE case for
    K in 1, 2, 4 (the container equal to the single-device one in the
    fixture and to the JAX package's tiled one for that K) and on the
    4096x3328 mammography frame with 6 Mbit over 4 bands (equal to the
    port's single-device container; both passes used), then
    ``encode_array_tiled`` / ``decode_container_tiled`` at 4096x3328 for
    hybrid and block_adaptive over 4 bands (equal to ``encode_array``);
    every decode exact. Returns (text, the launches of each path, (the
    inputs, each PEE case's final T))."""
    import numpy as np
    import torch
    import torch_port_cases as cases
    from codec_tcc_tpu_torch.io.container import parse_pee_ext
    from codec_tcc_tpu_torch.parallel import make_mesh, tile, tile_pee

    def mesh_of(k):
        return make_mesh(devices=[dev] * k, axes=("tile",))

    pee_cfg = port.EncodeConfig(strategy="pee")
    case = cases.BY_NAME[cases.TILED_PEE]
    big_pee, *big_raster = cases.TILED_BIG
    inputs = {c.name: (cases.image(c), cases.payload_bits(c, 0))
              for c in (case, *cases.TILED_BIG)}
    # the single-device containers of the 4096x3328 frames, before the
    # counted paths (they launch the whole-image kernels)
    singles = {}
    for c in cases.TILED_BIG:
        img, bits = inputs[c.name]
        singles[c.name] = port.encode_array(
            img, bits, c.config(port.EncodeConfig),
            bits_stored=c.bits_stored, device=dev).container
    runs = [(case, k) for k in cases.TILED_KS] + [(big_pee, cases.TILED_BIG_K)]
    expected = {"pee_count_band": 0, "pee_embed_band": 0,
                "pee_extract_count_band": 0, "pee_extract_band": 0}
    walls, thresholds = {}, {}

    def pee_path():
        out = []
        for c, k in runs:
            img, bits = inputs[c.name]
            mesh = mesh_of(k)
            t0 = time.perf_counter()
            res = tile_pee.encode_array_tiled_pee(img, bits, pee_cfg, mesh,
                                                  bits_stored=c.bits_stored)
            t1 = time.perf_counter()
            dec = tile_pee.decode_container_tiled_pee(res.container, mesh)
            t2 = time.perf_counter()
            out.append((c, k, img, bits, res, dec, t1 - t0, t2 - t1))
        return out

    for c, k, img, bits, res, dec, enc_s, dec_s in counted("tiled_pee",
                                                           pee_path):
        what = f"tiled PEE {c.name} over {k} bands"
        sha = cases.sha256(res.container)
        if c.name == case.name:
            check(sha == parity[c.name]["container_sha256"]
                  == tparity[f"{c.name}_k{k}"]["container_sha256"],
                  f"{what}: container differs from the single-device and "
                  f"the JAX package's tiled one")
        else:
            check(res.container == singles[c.name],
                  f"{what}: container differs from the single-device one")
        check(np.array_equal(dec.payload_bits, bits)
              and np.array_equal(dec.original, img),
              f"{what}: decode differs")
        t_final, passes = parse_pee_ext(res.meta.ext)[:2]
        check(passes == 2, f"{what}: one pass only")
        t_start = int(pee_start_thresholds(img[None], [bits.size],
                                           c.bits_stored, pee_cfg, dev)[0])
        # K count and K apply launches per pass: both passes of every
        # attempt that fell short, then the final attempt's; K of each per
        # inverse pass
        for name in ("pee_count_band", "pee_embed_band"):
            expected[name] += k * (2 * (t_final - t_start) + passes)
        for name in ("pee_extract_count_band", "pee_extract_band"):
            expected[name] += k * passes
        walls[(c.name, k)] = (enc_s, dec_s)
        thresholds[c.name] = t_final
        print(f"  {what}: T={t_final} from {t_start}, container "
              f"{len(res.container)} B equal, decode exact; walls (first "
              f"run) encode {enc_s * 1e3:.2f} ms, decode {dec_s * 1e3:.2f} "
              f"ms", flush=True)

    def raster_path():
        out = []
        for c in big_raster:
            img, bits = inputs[c.name]
            mesh = mesh_of(cases.TILED_BIG_K)
            res = tile.encode_array_tiled(img, bits, c.config(
                port.EncodeConfig), mesh, bits_stored=c.bits_stored)
            out.append((c, img, bits, res,
                        tile.decode_container_tiled(res.container, mesh)))
        return out

    for c, img, bits, res, dec in counted("tiled_raster", raster_path):
        check(res.container == singles[c.name],
              f"tiled {c.name}: container differs from encode_array's")
        check(np.array_equal(dec.payload_bits, bits)
              and np.array_equal(dec.original, img),
              f"tiled {c.name}: decode differs")
    text = (f"tiled PEE 2048x2048 over K={list(cases.TILED_KS)} equal to the "
            f"single-device and JAX tiled containers, 4096x3328 6 Mbit over "
            f"{cases.TILED_BIG_K} bands and tiled hybrid/block_adaptive at "
            f"4096x3328 equal to the single-device containers; all decodes "
            f"exact")
    return (text, {"tiled_pee": expected, "tiled_raster": {}},
            (inputs, thresholds))


DP_MESHES = (("k1", ("dp",), (1,)), ("k2", ("dp",), (2,)),
             ("k4", ("dp",), (4,)), ("2x2", ("dp", "tile"), (2, 2)))


def dp_mesh(dev, axes, shape):
    """A mesh of the card repeated: ``make_mesh(devices=[dev] * K)``."""
    import numpy as np
    from codec_tcc_tpu_torch.parallel import make_mesh

    return make_mesh(devices=[dev] * int(np.prod(shape)), axes=axes,
                     shape=shape)


def dp_pee_inputs():
    """The 8 x 512x512 uint16 PEE batch of phase 3d: the parity phantoms
    (seeds 700-707) with the 304-bit text and 20-80 kbit payloads, so the
    attempt groups have uneven sizes."""
    import numpy as np
    import torch_port_cases as cases

    imgs = np.stack([cases.image(cases.Case(f"dp_pee{i}", 512, 512,
                                            "uint16", 12, "text", "pee",
                                            700 + i)) for i in range(8)])
    rng = np.random.default_rng(707)
    text = cases.payload_bits(cases.BY_NAME["mr512_u16"], 0)
    pays = [text if i % 3 == 0 else
            rng.integers(0, 2, 20_000 * (1 + i % 4), dtype=np.uint8)
            for i in range(8)]
    return imgs, pays


def phase3_dp(port, parity, vparity, tparity, counted, launches,
              device_batches, volume_walls, dev):
    """The ``dp`` axis on the card: each full-width case over
    ``make_mesh(devices=["cuda:0"] * K, axes=("dp",))`` for K = 1, 2, 4
    and over a (2, 2) ``("dp", "tile")`` mesh (the counterpart of the JAX
    package's ``dryrun_multichip``): the container batches of phase 3 (B =
    32 x 512x512 and 8 x 2048x2048 uint16) through
    ``encode_batch_containers`` (one batch K1 per shard) and
    ``extract_batch`` (one batch K2 per shard), the 64 x 512x512 volume at
    half its LSB capacity through ``encode_volume`` + ``pack_volume`` and
    ``extract_volume``, an 8 x 512x512 PEE batch through
    ``encode_pee_batch`` (K3 twice per non-empty shard of each attempt
    group) and ``decode_batch_containers``, and the F1 batch over ``dp`` =
    1 and 3 (over 2 it does not split and raises ``ValueError``, as in the
    JAX package): containers and STGV equal to the unsharded run and to
    the fixture where the case is there. Returns (text, the launches of
    each path)."""
    import numpy as np
    import torch
    import torch_port_cases as cases
    from codec_tcc_tpu_torch.models.pee import max_value
    from codec_tcc_tpu_torch.parallel import batch as tb
    from codec_tcc_tpu_torch.parallel import batch_pee
    from codec_tcc_tpu_torch.parallel import volume as pv

    expected = {}
    cfg = port.EncodeConfig()
    for side, names in ((512, ("mr512_u16", "mr512_u16_full")),
                        (2048, ("cr2048_u16_full",))):
        imgs, pays, unsharded = device_batches[side]
        for tag, axes, shape in DP_MESHES:
            mesh, dp = dp_mesh(dev, axes, shape), shape[0]
            path = f"dp_batch_{side}_{tag}"
            res = counted(path, lambda: tb.encode_batch_containers(
                imgs, pays, cfg, mesh, bits_stored=12, device=dev))
            expected[path] = launches(raster_embed_batch=dp)
            check(res.containers == unsharded.containers,
                  f"{path}: containers differ from the unsharded run's")
            for name, blob in zip(names, res.containers):
                check(cases.sha256(blob) == parity[name]["container_sha256"],
                      f"{path}: the container of {name} differs from the "
                      f"JAX package's")
            path = f"dp_extract_{side}_{tag}"
            bits = counted(path, lambda: tb.extract_batch(
                res.stego, res.plan, mesh, device=dev))
            expected[path] = launches(raster_extract_batch=dp)
            for i, want in enumerate(pays):
                check(np.array_equal(bits[i, :want.size], want),
                      f"{path}: payload {i} differs")
        print(f"  dp batch B={len(imgs)} {side}x{side} u16 over "
              f"{[t for t, _, _ in DP_MESHES]}: containers equal to the "
              f"unsharded run and the JAX package's for {list(names)}, "
              f"extract exact", flush=True)

    vol, vbits, vcfg, vres, vblob = volume_walls["vol64_u16_hybrid_half"]
    vsha = vparity["vol64_u16_hybrid_half"]["stgv_sha256"]
    for tag, axes, shape in DP_MESHES:
        mesh, dp = dp_mesh(dev, axes, shape), shape[0]
        path = f"dp_volume_{tag}_encode"
        blob = counted(path, lambda: pv.pack_volume(
            vol, pv.encode_volume(vol, vbits, vcfg, mesh, device=dev), vcfg,
            device=dev))
        expected[path] = launches(raster_embed_batch=dp)
        check(blob == vblob and cases.sha256(blob) == vsha,
              f"{path}: STGV differs from the unsharded run's and the JAX "
              f"package's")
        path = f"dp_volume_{tag}_extract"
        got = counted(path, lambda: pv.extract_volume(vres.stego, vres.plan,
                                                      mesh, device=dev))
        expected[path] = launches(raster_extract_batch=dp)
        check(np.array_equal(got, vbits), f"{path}: payload differs")
    print(f"  dp volume 64x512x512 u16 hybrid, {vbits.size} bits: STGV equal "
          f"to the unsharded run's and the JAX package's, extract exact",
          flush=True)

    pee_cfg = port.EncodeConfig(strategy="pee")
    imgs, pays = dp_pee_inputs()
    unsharded = batch_pee.encode_pee_batch(imgs, pays, pee_cfg,
                                           bits_stored=12, device=dev)
    t_start = batch_pee._start_thresholds(
        torch.from_numpy(imgs).to(dev), [p.size for p in pays],
        max_value(int(imgs.max()), 16, 12), pee_cfg.pee_threshold)
    groups = cases.pee_attempt_group_lists(t_start, unsharded.thresholds)
    n_t = len(set(unsharded.thresholds.tolist()))
    for tag, axes, shape in DP_MESHES:
        mesh, dp = dp_mesh(dev, axes, shape), shape[0]
        path = f"dp_pee_{tag}"

        def pee_path():
            res = batch_pee.encode_pee_batch(imgs, pays, pee_cfg, mesh,
                                             bits_stored=12, device=dev)
            return res, tb.decode_batch_containers(res.containers, mesh,
                                                   device=dev)

        res, decs = counted(path, pee_path)
        shards = cases.pee_group_shards(groups, dp, mesh.size)
        expected[path] = launches(
            pee_embed=2 * sum(len(sizes) for sizes in shards),
            pee_extract=2 * n_t)
        check(res.containers == unsharded.containers,
              f"{path}: containers differ from the unsharded run's")
        for i, dec in enumerate(decs):
            check(np.array_equal(dec.payload_bits, pays[i])
                  and np.array_equal(dec.original, imgs[i]),
                  f"{path}: decode {i} differs")
    print(f"  dp PEE batch 8 x 512x512 u16 (groups "
          f"{[len(i) for _, i in groups]}): containers equal to the "
          f"unsharded run's, decodes exact", flush=True)

    imgs, pays = cases.f1_batch()
    f1_cfg = port.EncodeConfig(strategy="pee",
                               pee_threshold=cases.F1_THRESHOLD)
    want = tparity["f1_pee_batch"]["container_sha256"]
    t_start = batch_pee._start_thresholds(
        torch.from_numpy(imgs).to(dev), [p.size for p in pays],
        max_value(int(imgs.max()), 16, 16), cases.F1_THRESHOLD)
    for dp in (1, 3):
        mesh = dp_mesh(dev, ("dp",), (dp,))
        path = f"dp_f1_{dp}"
        res = counted(path, lambda: batch_pee.encode_pee_batch(
            imgs, pays, f1_cfg, mesh, device=dev))
        groups = cases.pee_attempt_group_lists(t_start, res.thresholds)
        shards = cases.pee_group_shards(groups, dp, mesh.size)
        expected[path] = launches(
            pee_embed=2 * sum(len(sizes) for sizes in shards))
        check([cases.sha256(c) for c in res.containers] == want,
              f"{path}: containers differ from the JAX package's")
    try:
        batch_pee.encode_pee_batch(imgs, pays, f1_cfg,
                                   dp_mesh(dev, ("dp",), (2,)), device=dev)
        fail("F1 batch of 3 over dp = 2: no ValueError")
    except ValueError:
        pass
    return (f"dp axis over {[t for t, _, _ in DP_MESHES]} of the card: "
            f"batches, the volume, the PEE batch and the F1 batch equal to "
            f"the unsharded run and the fixture"), expected


def phase3_multihost(port, dev):
    """Two processes of ``tests/torch_multihost_worker.py`` on ``cuda:0``,
    joined by ``gloo`` through ``initialize_distributed``, each with a
    ``dp`` mesh of two shards of the card and half of a global batch of
    four 32x32 uint16 images; they load the kernel library phase 1 built.
    Their cut point and checksums (summed across the processes) must agree
    and equal the same batch run unsharded in this process; each process
    launches batch K1 and batch K2 once per shard. Returns (text, the
    launches of each worker)."""
    import socket

    import numpy as np
    import torch
    from codec_tcc_tpu_torch.parallel import batch as tb
    from codec_tcc_tpu_torch.parallel import volume as pv

    worker = os.path.join(HERE, "tests", "torch_multihost_worker.py")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        free = s.getsockname()[1]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (HERE, env.get("PYTHONPATH")) if p)
    worker_dev = "cuda:0" if dev.type == "cuda" else "cpu"
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, worker, str(rank), "2", str(free), worker_dev],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=300)
            check(p.returncode == 0,
                  f"multihost worker failed:\n{out}\n{err[-2000:]}")
            verdicts = [ln for ln in out.splitlines()
                        if ln.startswith("VERDICT")]
            check(len(verdicts) == 1, f"multihost worker printed {out!r}")
            outs.append(dict(kv.split("=") for kv in verdicts[0].split()[1:]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    workers_s = time.perf_counter() - t0

    # the same global batch, unsharded, in this process
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 4096, size=(4, 32, 32)).astype(np.uint16)
    payloads = [rng.integers(0, 2, size=150).astype(np.uint8)
                for _ in range(4)]
    hists = np.stack([np.bincount(im.reshape(-1), minlength=65536)
                      for im in imgs])
    cfg = port.EncodeConfig(beta=0.4)
    plan = tb.plan_batch(imgs, payloads, cfg, histograms=hists,
                         base_offsets=tb.hybrid_base_offsets_host(
                             imgs, 32, 32, cfg.search_block_size))
    s, _ = pv.volume_cut_point(imgs, 0.4, device=dev)
    stego = tb.encode_batch(imgs, plan, device=dev)
    aligned = tb.extract_aligned_batch(stego, plan, device=dev)
    want = {"s": str(s), "chk_stego": str(int(stego.to(torch.int64).sum())),
            "chk_bits": str(int(aligned.to(torch.int64).sum()))}
    for f in outs:
        check(f["nproc"] == "2" and f["devices"] == "4",
              f"multihost: a worker saw {f}")
        for key, v in want.items():
            check(f[key] == v, f"multihost rank {f['proc']}: {key} "
                               f"{f[key]} != the single process's {v}")
    launched = {f"multihost_rank{f['proc']}":
                {k: int(v) for k, v in (kv.split(":") for kv in
                                        f["launches"].split(","))}
                for f in outs}
    return (f"two gloo processes on {dev}, dp mesh of 2 each: s={want['s']} "
            f"and checksums equal to the single process's (both workers "
            f"done in {workers_s:.1f} s)"), launched


def time_dp(port, device_batches, volume_walls, smi, dev) -> None:
    """The walls of the ``dp`` paths over K = 1, 2, 4 shards of the card,
    the K in turns within each round: ``encode_batch_containers`` (the
    default config) and ``decode_batch_containers`` at B = 32 x 512x512
    uint16 with the 304-bit text (median of 5 after a warm-up round), and
    ``encode_volume`` + ``pack_volume`` and ``extract_volume`` at the 64 x
    512x512 volume with half its LSB capacity (median of 3); then batch
    K1/K2 per shard at each K, queued behind a spin (CUDA events) and as
    ``torch.profiler`` device time."""
    import numpy as np
    import torch_port_cases as cases
    from codec_tcc_tpu_torch.device import upload
    from codec_tcc_tpu_torch.ops import raster_kernels as rk
    from codec_tcc_tpu_torch.parallel import batch as tb
    from codec_tcc_tpu_torch.parallel import volume as pv
    from codec_tcc_tpu_torch.parallel.mesh import dp_shards
    from codec_tcc_tpu_torch.pipeline import _next_pow2

    ks = (1, 2, 4)
    meshes = {k: dp_mesh(dev, ("dp",), (k,)) for k in ks}
    imgs, _ = batch_inputs((), 32, 512, 512, seed=9000)
    text = cases.payload_bits(cases.BY_NAME["mr512_u16"], 0)
    pays = [text] * len(imgs)
    cfg = port.EncodeConfig()
    vol, vbits, vcfg, vres, vblob = volume_walls["vol64_u16_hybrid_half"]
    blobs = tb.encode_batch_containers(imgs, pays, cfg, bits_stored=12,
                                       device=dev).containers
    calls = {
        "batch encode": lambda m: tb.encode_batch_containers(
            imgs, pays, cfg, m, bits_stored=12, device=dev),
        "batch decode": lambda m: tb.decode_batch_containers(
            blobs, m, device=dev),
        "encode_volume + pack_volume": lambda m: pv.pack_volume(
            vol, pv.encode_volume(vol, vbits, vcfg, m, device=dev), vcfg,
            device=dev),
        "extract_volume": lambda m: pv.extract_volume(
            vres.stego, vres.plan, m, device=dev),
    }
    walls = {(what, k): [] for what in calls for k in ks}
    for rep in range(6):
        for what, fn in calls.items():
            if what in ("encode_volume + pack_volume", "extract_volume") \
                    and rep > 3:
                continue
            for k in ks:
                t0 = time.perf_counter()
                out = fn(meshes[k])
                if rep:
                    walls[(what, k)].append((time.perf_counter() - t0) * 1e3)
                if what == "batch encode":
                    check(out.containers == blobs,
                          f"dp walls: K={k} containers differ")
                elif what == "encode_volume + pack_volume":
                    check(out == vblob, f"dp walls: K={k} STGV differs")
    for what in calls:
        meds = {k: statistics.median(walls[(what, k)]) for k in ks}
        ratios = ", ".join(f"K={k} {meds[k]:.2f} ms ({meds[k] / meds[1]:.3f}x)"
                           for k in ks)
        print(f"  dp {what}: {ratios} host wall (median of "
              f"{len(walls[(what, 1)])}) on {smi}", flush=True)

    # the kernels alone: each shard's images, stego and message rows are on
    # its device before the timed calls (the plan table's upload stays in
    # the wrapper, as in time_batch_kernels)
    imgs512, _, res = device_batches[512]
    plan = res.plan
    msgs = tb._msg_prefix(plan)
    max_s = int(plan.s.max())
    out_len = _next_pow2(int(plan.payload_bits.max()))
    for k in ks:
        times = {"k1": [], "k2": [], "dev_k1": [], "dev_k2": []}
        for shard_dev, rows in dp_shards(len(imgs512), meshes[k]):
            part = upload(imgs512[rows], shard_dev)
            msgs_part = upload(np.ascontiguousarray(msgs[rows]), shard_dev)
            st_part = upload(res.stego[rows], shard_dev)
            args = (plan.starts[rows], plan.lengths[rows],
                    plan.offsets[rows], plan.s[rows])
            calls = {
                "k1": lambda: rk.raster_embed_batch(
                    part, msgs_part, *args, emit_maps=True, max_s=max_s),
                "k2": lambda: rk.raster_extract_batch(st_part, *args,
                                                      out_len),
            }
            for name, fn in calls.items():
                # CUDA events with the launch queued behind a spin (the
                # profiler's reading of one small launch is not always
                # recorded), then the profiler's device time
                times[name].append(queued_ms(fn, cold=False))
                times[f"dev_{name}"].append(device_ms(fn))
        total = {name: None if None in v else sum(v)
                 for name, v in times.items()}
        print(f"  dp K={k} B=32 512x512 u16, per shard, queued after a "
              f"spin: batch K1 (maps over {max_s} planes) "
              f"{[fmt_ms(v) for v in times['k1']]}, sum "
              f"{fmt_ms(total['k1'])}; batch K2 (out_len {out_len}) "
              f"{[fmt_ms(v) for v in times['k2']]}, sum "
              f"{fmt_ms(total['k2'])}; profiler device: K1 "
              f"{[fmt_ms(v) for v in times['dev_k1']]}, K2 "
              f"{[fmt_ms(v) for v in times['dev_k2']]} on {smi}",
              flush=True)


def time_tiled(tiled_inputs, thresholds, dev) -> dict:
    """The tiled PEE path: encode and decode host walls at 2048x2048 u16, 3
    Mbit, for K = 1, 2, 4 beside the single-device
    ``encode_array``/``decode_container``, in turns (three rounds, the
    order reversed each round; median of 3); then K3/K4's band launches,
    band by band at K = 4 on the case's four real passes, and on band 1 of
    the 4096x3328 frame's pass 0 and its inverse: per call, device time
    (profiler, by kernel), the plain version per call and the bound of
    each launch's bytes; beside K4's, the look-back design at the same
    band (the whole-image K4 on the band as its own image, its memset of
    status words and a band-sized bit row included). Returns band 1's
    times of the 2048x2048 case for the kernels line."""
    import torch
    import torch_port_cases as cases
    import torch_tile_cases as tiles
    import codec_tcc_tpu_torch as port
    from codec_tcc_tpu_torch.models.pee import message_buffer
    from codec_tcc_tpu_torch.ops import pee as pee_ops
    from codec_tcc_tpu_torch.ops import pee_kernels as pk
    from codec_tcc_tpu_torch.parallel import make_mesh, tile_pee

    case = cases.BY_NAME[cases.TILED_PEE]
    img, bits = tiled_inputs[case.name]
    cfg = port.EncodeConfig(strategy="pee")
    blob = port.encode_array(img, bits, cfg, bits_stored=12,
                             device=dev).container
    calls = {"single-device": (
        lambda: port.encode_array(img, bits, cfg, bits_stored=12,
                                  device=dev),
        lambda: port.decode_container(blob, device=dev))}
    for k in cases.TILED_KS:
        mesh = make_mesh(devices=[dev] * k, axes=("tile",))
        calls[f"K={k}"] = (
            lambda mesh=mesh: tile_pee.encode_array_tiled_pee(
                img, bits, cfg, mesh, bits_stored=12),
            lambda mesh=mesh: tile_pee.decode_container_tiled_pee(blob,
                                                                  mesh))
    walls = {what: ([], []) for what in calls}
    order = list(calls)
    for rnd in range(3):
        for what in (order if rnd % 2 == 0 else order[::-1]):
            for fn, times in zip(calls[what], walls[what]):
                t0 = time.perf_counter()
                fn()
                times.append((time.perf_counter() - t0) * 1e3)
    single = [statistics.median(v) for v in walls["single-device"]]
    for what, (enc, dec) in walls.items():
        e, d = statistics.median(enc), statistics.median(dec)
        print(f"  tiled PEE 2048x2048 u16 3 Mbit {what}: encode {e:.2f} ms "
              f"({e / single[0]:.3f}x single), decode {d:.2f} ms "
              f"({d / single[1]:.3f}x single) host wall (median of 3, in "
              f"turns; encode {', '.join(f'{v:.2f}' for v in enc)}, decode "
              f"{', '.join(f'{v:.2f}' for v in dec)})", flush=True)

    def i32(v):
        return torch.tensor([int(v)], dtype=torch.int32, device=dev)

    def row(label, kern, plain, kernel_name, nbytes, n):
        """Time one launch: per call (CUDA events), device (profiler, the
        named kernel alone), the plain version per call, the bound."""
        ops = dict(device_ops_ms(kern))
        out = {"ms": cuda_median_ms(kern),
               "plain_ms": cuda_median_ms(plain),
               "dev_ms": ops.get(kernel_name),
               "bound": bound(nbytes, K3_K4_OPS_PER_PIXEL * n)}
        print(f"  {label}: per call {out['ms']:.4f} ms (plain "
              f"{out['plain_ms']:.4f} ms), device {fmt_ms(out['dev_ms'])}, "
              f"bound {out['bound'][0]:.4f} ms ({nbytes} B)", flush=True)
        return out

    def band_launches(what, over, k, passes, only_band=None):
        """Time the band launches of each pass over the K bands of its
        source; returns band 1's times."""
        times = {}
        for key, (kind, x, par, arg, want) in passes.items():
            h, w = x.shape[1:]
            rank_base = 0
            for b, (a, e) in enumerate(tiles.bands(h, k)):
                top, bot = tiles.halo(x, a, e)
                band = x[:, a:e].contiguous()
                n = band.numel()
                tiles_n = -(-n // pee_ops.TILE_PX)
                label = f"{what} {key} band {b} rows {a}-{e}"
                timed = only_band is None or b == only_band
                if kind == "embed":
                    cnt_args = (band, top, bot, a, h, par, t, max_val)
                    counts = pk.pee_count_band(*cnt_args)
                    app = (band, top, bot, a, h, counts,
                           i32(rank_base) if a else None, msg, arg, want,
                           par, t, max_val)
                    count = int(counts.sum())
                    # embedded bits of the band: its eligible pixels below
                    # want
                    emb = max(0, min(count, want - rank_base))
                    rank_base += count
                    if not timed:
                        continue
                    # count: the band and its halo rows read, the counts
                    # written; apply: the band, halo rows, counts and the
                    # band's message bits read, stego and overflow written
                    parts = {
                        "count": row(
                            f"{label} count", lambda a_=cnt_args:
                            pk.pee_count_band(*a_), lambda a_=cnt_args:
                            pk.pee_count_band_plain(*a_),
                            "pee_count_band_kernel",
                            2 * n + 4 * w + 4 * tiles_n, n),
                        "apply": row(
                            f"{label} apply", lambda a_=app:
                            pk.pee_embed_band(*a_), lambda a_=app:
                            pk.pee_embed_band_plain(*a_),
                            "pee_embed_band_kernel",
                            2 * n + 4 * w + 4 * tiles_n + emb + 2 * n + n,
                            n)}
                else:
                    if not timed:
                        continue
                    ov = over[:, a:e].contiguous()
                    args = (band, top, bot, a, h, ov, arg, par, t)
                    nb = int(pk.pee_extract_band(*args, out_len)[2][0])
                    # count: stego, overflow and halo read, counts written;
                    # apply: the same and the counts read, the restored
                    # band and its bits written
                    parts = {
                        "count": row(
                            f"{label} count", lambda a_=args:
                            pk.pee_extract_count_band(*a_), lambda a_=args:
                            pk.pee_extract_count_band_plain(*a_),
                            "pee_extract_count_band_kernel",
                            2 * n + n + 4 * w + 4 * tiles_n, n),
                        "apply": row(
                            f"{label} apply (per call: with its count "
                            f"launch)", lambda a_=args:
                            pk.pee_extract_band(*a_, out_len),
                            lambda a_=args:
                            pk.pee_extract_band_plain(*a_, out_len),
                            "pee_extract_band_kernel",
                            2 * n + n + 4 * w + 4 * tiles_n + 2 * n + nb,
                            n)}
                    # the look-back design at this band: one memset (its
                    # status words, ticket and a band-sized bit row) and
                    # one launch
                    row_len = max(1, min(out_len, pee_ops.band_set_count(
                        a, e - a, h, w, par)))
                    lb = (lambda band=band, ov=ov, arg=arg, par=par,
                          row_len=row_len: pk.pee_extract(
                              band, ov, i32(arg), par, t, row_len))
                    ops = dict(device_ops_ms(lb))
                    memset = sum(v for name, v in ops.items()
                                 if name.startswith("Memset")) or None
                    print(f"  {label}, the look-back design (whole-image "
                          f"K4 on the band, bit row {row_len} B): per call "
                          f"{cuda_median_ms(lb):.4f} ms, device "
                          f"{fmt_ms(ops.get('pee_extract_kernel'))} + "
                          f"memset {fmt_ms(memset)}", flush=True)
                if b == 1:
                    times.update({(key, p): v for p, v in parts.items()})
        return times

    def four_passes(x_img, nbits):
        """K3 pass 0 and 1, K4 pass 1 and 0 of ``x_img`` at ``nbits`` (the
        whole-image kernels make each pass's input): (the passes, the
        overflow map)."""
        s0, o0, u0, n0, _ = pk.pee_embed(x_img, msg, i32(0), i32(nbits), 0,
                                         t, max_val)
        used0 = int(u0[0])
        s1, o1, _, n1, _ = pk.pee_embed(s0, msg, u0, i32(nbits) - u0, 1, t,
                                        max_val)
        over = o0 | o1
        r1 = pk.pee_extract(s1, over, n1, 1, t, out_len)[0]
        return {
            "k3_pass0": ("embed", x_img, 0, 0, nbits),
            "k3_pass1": ("embed", s0, 1, used0, nbits - used0),
            "k4_pass1": ("extract", s1, 1, int(n1[0]), None),
            "k4_pass0": ("extract", r1, 0, int(n0[0]), None),
        }, over

    # the 2048x2048 case at K = 4, every band of its four passes; then
    # band 1 of the 4096x3328 frame over 4 bands, pass 0 and its inverse
    times = {}
    for c, keys, only in ((case, None, None),
                          (cases.TILED_BIG[0], ("k3_pass0", "k4_pass0"), 1)):
        x, nbits = tiled_inputs[c.name]
        t = thresholds[c.name]
        max_val = (1 << c.bits_stored) - 1
        msg = message_buffer([nbits], dev)
        out_len = 1 << max(3, (nbits.size - 1).bit_length())
        passes, over = four_passes(torch.from_numpy(x).to(dev)[None],
                                   nbits.size)
        if keys:
            passes = {key: passes[key] for key in keys}
        got = band_launches(f"{x.shape[0]}x{x.shape[1]} u16 T={t}", over,
                            cases.TILED_BIG_K, passes, only)
        if c is case:
            times = got
    return {"pee_count_band": times[("k3_pass0", "count")],
            "pee_embed_band": times[("k3_pass0", "apply")],
            "pee_extract_count_band": times[("k4_pass1", "count")],
            "pee_extract_band": times[("k4_pass1", "apply")]}


def build_native():
    """Build and load the ``jls`` library from
    ``codec_tcc_tpu_torch/native`` (g++), and the ``jxl`` shim where a
    system libjxl exists. Returns the text for phase 1."""
    from codec_tcc_tpu_torch.io import codecs as codec_reg
    from codec_tcc_tpu_torch.io import jpegls_binding, jxl_binding

    t0 = time.perf_counter()
    try:
        jpegls_binding.load_library()
    except RuntimeError as exc:
        fail(f"the jls library did not build: {exc}")
    jls_s = time.perf_counter() - t0
    libjxl = jxl_binding._find_libjxl()
    shim = "not built (no libjxl)"
    if libjxl is not None:
        try:
            jxl_binding.load_library()
            shim = "built"
        except RuntimeError as exc:
            shim = f"not built ({str(exc).splitlines()[0][:120]})"
    return (f"jls library built in {jls_s:.2f} s -> "
            f"{os.path.relpath(jpegls_binding._LIB_PATH, HERE)}; libjxl "
            f"{libjxl or 'not found'}, jxl shim {shim}; available codecs "
            f"{codec_reg.available_names()}")


def phase3_codecs(port, cparity, counted, launches, dev):
    """The other transport codecs and STGC v1 on the card: ``jls`` on six
    parity images and v1 + ``jls`` hybrid (``CODEC_CASES``), each container
    equal to the JAX package's (the fixture's ``codecs`` section), decoded
    and restored exactly; the ``jls`` volume's STGV; ``png``/``j2k``
    unavailable where Pillow is absent, exact round trips where it is
    present; a ``jxl`` round trip where the shim built. Returns (text, the
    launches each path must make)."""
    import numpy as np
    import torch_port_cases as cases
    from codec_tcc_tpu_torch.io import codecs as codec_reg
    from codec_tcc_tpu_torch.io import jxl_binding
    from codec_tcc_tpu_torch.io.container import parse_pee_ext
    from codec_tcc_tpu_torch.parallel import volume as pv

    expected = {}
    pee_cfg = port.EncodeConfig(strategy="pee")
    want_launch = dict(raster_embed=0, raster_extract=0, pee_embed=0,
                       pee_extract=0)

    def run():
        out = {}
        for case in cases.CODEC_CASES:
            want = cparity[case.name]
            img, s, bits = case_payload(case, dev)
            check(cases.sha256(bits) == want["payload_sha256"],
                  f"{case.name}: payload differs from the fixture's")
            res = port.encode_array(img, bits, case.config(port.EncodeConfig),
                                    bits_stored=case.bits_stored, device=dev)
            check(res.s == want["s"] == s,
                  f"{case.name}: s={res.s} != {want['s']}")
            if case.strategy == "pee":
                ext = list(parse_pee_ext(res.meta.ext))
                check(ext == want["pee_ext"],
                      f"{case.name}: PEE ext {ext} != {want['pee_ext']}")
            check(cases.sha256(res.container) == want["container_sha256"],
                  f"{case.name}: container differs from the JAX package's")
            dec = port.decode_container(res.container, device=dev)
            check(np.array_equal(dec.payload_bits, bits),
                  f"{case.name}: decoded payload differs")
            check(dec.original is not None
                  and dec.original.dtype == img.dtype
                  and np.array_equal(dec.original, img),
                  f"{case.name}: restored original differs")
            out[case.name] = (img, bits, res)
        return out

    got = counted("codecs", run)
    for case in cases.CODEC_CASES:
        img, bits, res = got[case.name]
        if case.strategy == "pee":
            t0 = pee_start_thresholds(img[None], [bits.size],
                                      case.bits_stored, pee_cfg, dev)
            groups = cases.pee_attempt_groups(
                t0, [parse_pee_ext(res.meta.ext)[0]])
            want_launch["pee_embed"] += 2 * groups
            want_launch["pee_extract"] += 2
        elif case.strategy != "block_adaptive":
            want_launch["raster_embed"] += 1
            want_launch["raster_extract"] += 1
        print(f"  {case.name}: {res.meta.codec} v{res.meta.version} "
              f"{case.strategy} payload={bits.size} bits container="
              f"{len(res.container)} B sha256 ok, decode ok", flush=True)
    expected["codecs"] = launches(**want_launch)

    vcase = cases.CODEC_VOLUME
    want = cparity[vcase.name]
    vol, bits = volume_inputs(vcase, cparity)
    cfg = vcase.config(port.EncodeConfig)

    def encode_volume():
        res = pv.encode_volume(vol, bits, cfg, device=dev)
        return res, pv.pack_volume(vol, res, cfg, device=dev)

    res, blob = counted("codecs_volume", encode_volume)
    expected["codecs_volume"] = launches(raster_embed_batch=1)
    check(cases.sha256(blob) == want["stgv_sha256"],
          f"{vcase.name}: STGV differs from the JAX package's")
    payload, _, original = counted(
        "codecs_volume_unpack", lambda: pv.unpack_volume(blob, device=dev))
    expected["codecs_volume_unpack"] = launches()
    check(np.array_equal(payload, bits) and np.array_equal(original, vol),
          f"{vcase.name}: unpacked payload or volume differs")
    print(f"  {vcase.name}: {vcase.depth}x{vcase.height}x{vcase.width} jls "
          f"STGV={len(blob)} B sha256 ok, unpack ok", flush=True)

    if codec_reg._pil_available():
        # png/j2k bytes depend on the Pillow build: round trips only
        img, _, bits = case_payload(cases.BY_NAME["mr512_u16"], dev)
        pil_codecs = [n for n in ("png", "j2k")
                      if n in codec_reg.available_names()]

        def pil_cycles():
            out = {}
            for name in pil_codecs:
                res = port.encode_array(img, bits,
                                        port.EncodeConfig(codec=name),
                                        bits_stored=12, device=dev)
                out[name] = (res, port.decode_container(res.container,
                                                        device=dev))
            return out

        got = counted("codecs_pil", pil_cycles)
        n_pil = len(pil_codecs)
        expected["codecs_pil"] = launches(raster_embed=n_pil,
                                          raster_extract=n_pil)
        for name, (res, dec) in got.items():
            check(np.array_equal(dec.payload_bits, bits)
                  and np.array_equal(dec.original, img),
                  f"{name} round trip on mr512_u16 is not exact")
        pil = ("Pillow present: " + ", ".join(
            f"{name} round trip on mr512_u16 exact, container "
            f"{len(res.container)} B" for name, (res, _) in got.items())
            + " (not compared: the bytes depend on the Pillow build)")
    else:
        for name in ("png", "j2k"):
            check(name not in codec_reg.available_names(),
                  f"{name} reports available without Pillow")
            try:
                codec_reg.get(name)
            except RuntimeError:
                continue
            fail(f"get({name!r}) did not raise RuntimeError without Pillow")
        pil = "no Pillow: png/j2k unavailable, get() raises RuntimeError"

    jxl = "jxl: no in-process shim, not run"
    if jxl_binding._lib is not None:
        img, _, bits = case_payload(cases.BY_NAME["mr512_u16"], dev)

        def jxl_cycle():
            res = port.encode_array(img, bits, port.EncodeConfig(codec="jxl"),
                                    bits_stored=12, device=dev)
            return res, port.decode_container(res.container, device=dev)

        res, dec = counted("codecs_jxl", jxl_cycle)
        expected["codecs_jxl"] = launches(raster_embed=1, raster_extract=1)
        check(np.array_equal(dec.payload_bits, bits)
              and np.array_equal(dec.original, img),
              "jxl round trip on mr512_u16 is not exact")
        jxl = (f"jxl round trip on mr512_u16 exact, container "
               f"{len(res.container)} B (libjxl "
               f"{jxl_binding.runtime_version()}; not compared: the bytes "
               f"depend on the libjxl build)")
    return (f"{len(cases.CODEC_CASES)} jls cases (v1 included) and the jls "
            f"volume byte-identical to the JAX package, decoded and restored "
            f"exactly; {pil}; {jxl}"), expected


def serve_request(sock, obj):
    """One request to the daemon; a failed answer stops the run."""
    from codec_tcc_tpu_torch.serve import request

    r = request(sock, obj, timeout=600)
    check(r.get("ok"), f"serve {obj.get('op')}: {r}")
    return r


def phase5_serve(port, sparity, counted, launches, dev):
    """The serving daemon on the card: ``serve.serve(sock,
    warmup="512x512", device=dev)`` in a thread of this process (so the
    launch counts see its kernels), then its ops on DICOM and ``.npy``
    files, each answer against the fixture's ``serve`` section, a bad
    request, the warm latencies and ``shutdown``. Returns (text, the
    launches each path must make, the latencies)."""
    import threading

    import numpy as np
    import torch
    import torch_port_cases as cases
    from codec_tcc_tpu_torch import serve
    from codec_tcc_tpu_torch.io import dicom
    from codec_tcc_tpu_torch.io.container import parse as parse_container
    from codec_tcc_tpu_torch.io.container import parse_pee_ext
    from codec_tcc_tpu_torch.ops import deflate_rle as dfl
    from codec_tcc_tpu_torch.ops import inflate as inf

    expected = {}
    tmp = tempfile.mkdtemp(prefix="ct_")
    sock = os.path.join(tmp, "ct.sock")
    rc = []
    t0 = time.perf_counter()
    thread = threading.Thread(
        target=lambda: rc.append(serve.serve(sock, warmup="512x512",
                                             device=dev)),
        daemon=True)
    thread.start()
    while not os.path.exists(sock):
        check(thread.is_alive() and time.perf_counter() - t0 < 300,
              "the daemon did not come up")
        time.sleep(0.05)
    up_s = time.perf_counter() - t0
    r = serve_request(sock, {"op": "ping"})
    check(r["backend"] == dev.type and r["device_count"] == (
        torch.cuda.device_count() if dev.type == "cuda" else 1),
          f"ping: {r}")

    text = cases.TEXT_PAYLOAD
    text_bits = np.unpackbits(np.frombuffer(text.encode(), np.uint8))
    files = {}
    for name, base, overrides in cases.SERVE_ENCODES:
        img = cases.image(cases.BY_NAME[base])
        path = os.path.join(tmp, f"{name}.dcm")
        dicom.save_image(img, path, bits_stored=12)
        out = os.path.join(tmp, f"{name}.stgc")
        config = cases.serve_config(base, overrides)
        req = {"op": "encode", "input": path, "output": out,
               "message": text, "config": config}
        r = counted(f"{name}_encode", lambda: serve_request(sock, req))
        with open(out, "rb") as f:
            blob = f.read()
        check(cases.sha256(blob) == sparity[name]["container_sha256"],
              f"{name}: the daemon's container differs from the JAX "
              f"package's encode_file")
        # the deflate codec's encode and decode of the stego on the card
        on_card = int(config.get("codec", "deflate") == "deflate")
        deflated = {k: on_card for k in dfl.KERNELS}
        inflated = {k: on_card for k in inf.KERNELS}
        if config["strategy"] == "pee":
            t_start = pee_start_thresholds(
                img[None], [text_bits.size], 12,
                port.EncodeConfig(**config), dev)
            t_final = parse_pee_ext(parse_container(blob).meta.ext)[0]
            groups = cases.pee_attempt_groups(t_start, [t_final])
            expected[f"{name}_encode"] = launches(pee_embed=2 * groups,
                                                  **deflated)
            expected[f"{name}_decode"] = launches(pee_extract=2, **inflated)
        else:
            expected[f"{name}_encode"] = launches(raster_embed=1, **deflated)
            expected[f"{name}_decode"] = launches(raster_extract=1,
                                                  **inflated)
        prefix = os.path.join(tmp, f"{name}_dec")
        d = counted(f"{name}_decode", lambda: serve_request(
            sock, {"op": "decode", "input": out, "output_prefix": prefix}))
        with open(d["payload_path"], encoding="utf-8") as f:
            check(f.read() == text, f"{name}: decoded message differs")
        original, _ = dicom.load_image(d["original_path"])
        stego, _ = dicom.load_image(d["stego_path"])
        check(np.array_equal(original, img), f"{name}: original differs")
        check(cases.sha256(stego) == sparity[name]["stego_sha256"],
              f"{name}: stego differs from the JAX package's")
        files[name] = (path, out, d["stego_path"])
        print(f"  serve {name}: {r['codec']} {r['strategy']} container "
              f"{r['container_bytes']} B sha256 ok, decode ok", flush=True)

    # encode_batch: one batch K1 for the four images; decode_batch on the
    # host (raster group)
    paths = []
    for k, img in enumerate(cases.serve_batch_images()):
        paths.append(os.path.join(tmp, f"b{k}.dcm"))
        dicom.save_image(img, paths[-1], bits_stored=12)
    enc_dir = os.path.join(tmp, "enc")
    r = counted("serve_encode_batch", lambda: serve_request(sock, {
        "op": "encode_batch", "inputs": paths, "output_dir": enc_dir,
        "message": text, "config": {}}))
    expected["serve_encode_batch"] = launches(raster_embed_batch=1)
    outs = [it["output"] for it in r["items"]]
    for k, out in enumerate(outs):
        with open(out, "rb") as f:
            check(cases.sha256(f.read())
                  == sparity["serve_batch"]["container_sha256"][k],
                  f"serve encode_batch item {k} differs from the JAX "
                  f"package's encode_file")
    dec_dir = os.path.join(tmp, "dec")
    d = counted("serve_decode_batch", lambda: serve_request(sock, {
        "op": "decode_batch", "inputs": outs, "output_dir": dec_dir}))
    expected["serve_decode_batch"] = launches()
    for it, path in zip(d["items"], paths):
        with open(it["payload_path"], encoding="utf-8") as f:
            check(f.read() == text, f"serve decode_batch {path}: message")
        check(np.array_equal(dicom.load_image(it["original_path"])[0],
                             dicom.load_image(path)[0]),
              f"serve decode_batch {path}: original differs")

    # encode_volume / decode_volume of the 8 x 512x512 .npy
    vol = cases.volume(cases.SERVE_VOLUME)
    vpath = os.path.join(tmp, "vol.npy")
    np.save(vpath, vol)
    vout = os.path.join(tmp, "vol.stgv")
    counted("serve_encode_volume", lambda: serve_request(sock, {
        "op": "encode_volume", "inputs": [vpath], "output": vout,
        "message": text, "config": {"strategy": "hybrid"}}))
    expected["serve_encode_volume"] = launches(raster_embed_batch=1)
    with open(vout, "rb") as f:
        check(cases.sha256(f.read()) == sparity["serve_volume"]["stgv_sha256"],
              "serve encode_volume: STGV differs from the JAX package's")
    d = counted("serve_decode_volume", lambda: serve_request(sock, {
        "op": "decode_volume", "input": vout,
        "output_prefix": os.path.join(tmp, "vdec")}))
    expected["serve_decode_volume"] = launches()
    with open(d["payload_path"], "rb") as f:
        check(f.read() == text.encode(), "serve decode_volume: payload")
    check(np.array_equal(np.load(d["original_path"]), vol),
          "serve decode_volume: original differs")

    # capacity (the K3 saturated probe, 2 launches) and analyze (none)
    mr_path, _, mr_stego = files["serve_mr512_u16"]
    r = counted("serve_capacity", lambda: serve_request(
        sock, {"op": "capacity", "input": mr_path}))
    expected["serve_capacity"] = launches(pee_embed=2)
    want = sparity["serve_capacity"]
    check({k: r[k] for k in want} == want,
          f"serve capacity {r} != the JAX package's {want}")
    r = counted("serve_analyze", lambda: serve_request(
        sock, {"op": "analyze", "original": mr_path, "stego": mr_stego}))
    expected["serve_analyze"] = launches()
    for k, v in sparity["serve_analyze"]["report"].items():
        if isinstance(v, float):
            # float32 moments in another order: rtol 1e-4
            check(abs(r[k] - v) <= 1e-4 * abs(v),
                  f"serve analyze: {k} {r[k]} != the JAX package's {v}")
        else:
            check(r[k] == v,
                  f"serve analyze: {k} {r[k]} != the JAX package's {v}")

    # a bad request answers ok: false and the daemon lives on
    from codec_tcc_tpu_torch.serve import request

    bad = counted("serve_errors", lambda: request(sock, {
        "op": "encode", "input": os.path.join(tmp, "nope.dcm"),
        "output": os.path.join(tmp, "nope.stgc"), "message": "m"}))
    expected["serve_errors"] = launches()
    check(not bad["ok"] and bad["error_type"] == "FileNotFoundError",
          f"serve: a bad request answered {bad}")

    # warm latency, median of 5 (outside the counted windows)
    _, mr_out, _ = files["serve_mr512_u16"]
    lat = {}
    for op, req in (
            ("encode", {"op": "encode", "input": mr_path,
                        "output": os.path.join(tmp, "lat.stgc"),
                        "message": text}),
            ("decode", {"op": "decode", "input": mr_out,
                        "output_prefix": os.path.join(tmp, "lat")})):
        walls, daemon_ms = [], []
        for _ in range(6):
            t1 = time.perf_counter()
            r = serve_request(sock, req)
            walls.append((time.perf_counter() - t1) * 1e3)
            daemon_ms.append(r["wall_ms"])
        lat[op] = (statistics.median(walls[1:]),
                   statistics.median(daemon_ms[1:]))

    ping = serve_request(sock, {"op": "ping"})
    r = request(sock, {"op": "shutdown"})
    thread.join(timeout=60)
    check(r.get("ok") and not thread.is_alive() and rc == [0]
          and not os.path.exists(sock),
          f"serve: shutdown did not end the daemon ({r}, rc {rc})")
    return (f"daemon up in {up_s:.1f} s (warm-up 512x512 on {dev}), "
            f"{ping['requests_served']} requests served "
            f"({ping['ops_served']}): containers, STGV, capacity and analyze "
            f"equal to the JAX package's, payloads and originals exact; a bad "
            f"request answered ok=false; shutdown ended the thread"), \
        expected, lat


def time_codecs(port, results, smi, dev) -> None:
    """``jls`` against ``deflate``: warm encode+decode cycles at 512x512
    (304 bits) and 2048x2048 (at capacity) uint16, the
    ``transport_codec`` and ``transport_decode`` stage means (host ms),
    the cycle's host wall (median) and the container bytes."""
    from codec_tcc_tpu_torch.profiling import get_profiler

    for name, reps in (("mr512_u16", 5), ("cr2048_u16_full", 3)):
        img, _, bits, _ = results[name]
        row = {}
        for codec in ("deflate", "jls", "jls", "deflate"):
            cfg = port.EncodeConfig(codec=codec)

            def cycle():
                res = port.encode_array(img, bits, cfg, bits_stored=12,
                                        device=dev)
                port.decode_container(res.container, device=dev)
                return res

            size = len(cycle().container)
            profiler = get_profiler()
            profiler.reset()
            walls = []
            for _ in range(reps):
                t0 = time.perf_counter()
                cycle()
                walls.append((time.perf_counter() - t0) * 1e3)
            rep = profiler.report()
            row.setdefault(codec, []).append(
                (rep["transport_codec"]["mean_ms"],
                 rep["transport_decode"]["mean_ms"],
                 statistics.median(walls), size))
        for codec, turns in row.items():
            enc = ", ".join(f"{t[0]:.2f}" for t in turns)
            dec = ", ".join(f"{t[1]:.2f}" for t in turns)
            wall = ", ".join(f"{t[2]:.2f}" for t in turns)
            print(f"  {name} {codec}: transport_codec {enc} ms, "
                  f"transport_decode {dec} ms, cycle host wall {wall} ms "
                  f"(two turns, median of {reps} each), container "
                  f"{turns[0][3]} B on {smi}", flush=True)


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a GPU")
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.join(HERE, "tests"))
    import codec_tcc_tpu_torch as port
    import torch_port_cases as cases
    from codec_tcc_tpu_torch.io.container import parse_pee_ext
    from codec_tcc_tpu_torch.ops import kernel_library
    from codec_tcc_tpu_torch import profiling
    from codec_tcc_tpu_torch.ops import deflate_rle as dfl
    from codec_tcc_tpu_torch.ops import inflate as inf
    from codec_tcc_tpu_torch.ops import pee_kernels as pk
    from codec_tcc_tpu_torch.ops import raster_kernels as rk

    dev = torch.device("cuda")

    # -- phase 1: card, build ------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    t0 = time.perf_counter()
    lib_path = kernel_library.build_library()
    kernel_library.library()
    phase(1, f"kernels built in {time.perf_counter() - t0:.2f} s -> "
             f"{os.path.relpath(lib_path, HERE)}; {build_native()}")

    # -- phase 2: kernels vs plain versions on the card ----------------------
    # the deflate kernels first: their probe runs at the process's first
    # encode on the card
    deflate_txt = phase2_deflate(dev)
    inflate_txt, inflate_err = phase2_inflate(dev)
    max_err = phase2_raster(np.random.default_rng(2024), dev)
    k1_err, k1_txt = phase2_k1(dev)
    max_err["raster_embed"] = max(max_err["raster_embed"], k1_err)
    k2_err, k2_txt = phase2_k2(dev)
    max_err["raster_extract"] = max(max_err["raster_extract"], k2_err)
    batch_err, batch_k_txt = phase2_batch(dev)
    max_err.update(batch_err)
    max_err.update(phase2_pee(dev))
    max_err.update(pee_count_band=0, pee_embed_band=0,
                   pee_extract_count_band=0, pee_extract_band=0)
    parity = cases.load_parity()
    shard_txt = phase2_pee_shard(dev, parity, max_err)
    stress_txt = phase2_pee_stress(dev)
    block_txt = phase2_block(port, dev)
    max_err.update({name: 0 for name in dfl.KERNELS})
    max_err.update({name: inflate_err for name in inf.KERNELS})
    phase(2, f"K1-K4, batch K1/K2, band K3/K4, the deflate kernels and the "
             f"inflate kernels == plain on the card (max abs err {max_err}); {k1_txt}; "
             f"{k2_txt}; {batch_k_txt}; {shard_txt}; {stress_txt}; "
             f"{block_txt}; {deflate_txt}; {inflate_txt}")

    # -- phase 3: the parity cases through the main path ---------------------
    # Each path runs with the launch counts set to 0 just before it and is
    # read just after it (phase 6 checks them).
    tparity = cases.load_parity_tiled()
    paths, expected = {}, {}
    kernel_names = rk.KERNELS + pk.KERNELS + dfl.KERNELS + inf.KERNELS

    def launches(**nonzero):
        """Launches by kernel: 0 for every kernel not named."""
        return {**{name: 0 for name in kernel_names}, **nonzero}

    def deflated(n):
        """The deflate kernels of n single-image encodes on the card."""
        return {name: n for name in dfl.KERNELS}

    def inflated(n):
        """The inflate kernels of n single-image decodes of a deflate stego
        on the card (the batch, tiled and volume decoders inflate on the
        host; the golden fixtures' code 2 is the host's)."""
        return {name: n for name in inf.KERNELS}

    def counted(path, fn):
        before = profiling.launches(kernel_names)
        out = fn()
        after = profiling.launches(kernel_names)
        paths[path] = {k: after[k] - before[k] for k in kernel_names}
        return out

    results = {}

    by_path = {}
    for case in cases.CASES:
        by_path.setdefault(case_path(port, case), []).append(case)

    def run_cases(path):
        for case in by_path[path]:
            want = parity[case.name]
            img, s, bits = case_payload(case)
            check(cases.sha256(bits) == want["payload_sha256"],
                  f"{case.name}: payload differs from the fixture's")
            res = port.encode_array(
                img, bits, case.config(port.EncodeConfig),
                bits_stored=case.bits_stored, device="cuda",
            )
            check(res.s == want["s"] == s,
                  f"{case.name}: s={res.s} != {want['s']}")
            if case.strategy == "pee":
                ext = list(parse_pee_ext(res.meta.ext))
                check(ext == want["pee_ext"],
                      f"{case.name}: PEE ext (T, passes, nproc0, nproc1, "
                      f"bits0, bits1) {ext} != the JAX package's "
                      f"{want['pee_ext']}")
            check(cases.sha256(res.container) == want["container_sha256"],
                  f"{case.name}: container differs from the JAX package's")
            dec = port.decode_container(res.container, device="cuda")
            check(np.array_equal(dec.payload_bits, bits),
                  f"{case.name}: decoded payload differs")
            check(dec.original is not None
                  and np.array_equal(dec.original, img),
                  f"{case.name}: restored original differs")
            results[case.name] = (img, s, bits, res)
            print(f"  {case.name}: s={res.s} payload={bits.size} bits "
                  f"container={len(res.container)} B sha256 ok, decode ok",
                  flush=True)

    n_path = {path: len(group) for path, group in by_path.items()}
    counted("raster", lambda: run_cases("raster"))
    expected["raster"] = launches(raster_embed=n_path["raster"],
                                  raster_extract=n_path["raster"],
                                  **deflated(n_path["raster"]),
                                  **inflated(n_path["raster"]))
    counted("pee", lambda: run_cases("pee"))
    pee_cfg = port.EncodeConfig(strategy="pee")
    groups = 0
    for case in by_path["pee"]:
        img, _, bits, res = results[case.name]
        t0 = pee_start_thresholds(img[None], [bits.size],
                                  case.bits_stored, pee_cfg, dev)
        groups += cases.pee_attempt_groups(
            t0, [parse_pee_ext(res.meta.ext)[0]])
    expected["pee"] = launches(pee_embed=2 * groups,
                               pee_extract=2 * n_path["pee"],
                               **deflated(n_path["pee"]),
                               **inflated(n_path["pee"]))
    # block_adaptive: torch ops on the card both ways, and the deflate and
    # inflate kernels
    counted("block", lambda: run_cases("block"))
    expected["block"] = launches(**deflated(n_path["block"]),
                                 **inflated(n_path["block"]))
    # the host embed route: no K1, host zlib; its containers inflate on
    # the card and decode through K2
    counted("host", lambda: run_cases("host"))
    expected["host"] = launches(raster_extract=n_path["host"],
                                **inflated(n_path["host"]))
    batch_txt, pee_batch = phase3_batch(port, results, parity, counted, dev)
    expected["pee_batch"] = launches(**pee_batch)
    f1_txt, f1_expected = phase3_f1(port, tparity, counted, dev)
    expected["pee_f1"] = launches(**f1_expected)
    raster_batch_txt, batch_expected, device_batches = phase3_raster_batch(
        port, parity, counted, launches)
    expected.update(batch_expected)
    phase(3, f"{len(cases.CASES)} parity cases ({n_path}) byte-identical to "
             f"the JAX package, decoded and restored exactly; PEE batch of "
             f"four 512x512 ({batch_txt}) equal to single-image encodes; "
             f"{f1_txt}; {raster_batch_txt}")

    # -- phase 3v: volumes, capacity and analyze -----------------------------
    vparity = cases.load_parity_volumes()
    volume_txt, volume_expected, volume_walls = phase3_volumes(
        port, vparity, counted, launches, dev, max_err=max_err)
    expected.update(volume_expected)
    phase("3v", volume_txt)

    # -- phase 3c: the other transport codecs and STGC v1 --------------------
    codecs_txt, codecs_expected = phase3_codecs(
        port, cases.load_parity_codecs(), counted, launches, dev)
    expected.update(codecs_expected)
    phase("3c", codecs_txt)

    # -- phase 3t: one image across a mesh (the tile axis) -------------------
    tiled_txt, tiled_expected, tiled_inputs = phase3_tiled(
        port, parity, tparity, counted, dev)
    for path, nonzero in tiled_expected.items():
        expected[path] = launches(**nonzero)
    phase("3t", tiled_txt)

    # -- phase 3d: batches split over the dp axis of a mesh of the card ------
    dp_txt, dp_expected = phase3_dp(
        port, parity, vparity, tparity, counted, launches, device_batches,
        volume_walls, dev)
    expected.update(dp_expected)
    phase("3d", dp_txt)

    # -- phase 3m: two processes joined by gloo, a dp mesh each --------------
    multihost_txt, multihost_launches = phase3_multihost(port, dev)
    for path, counts in multihost_launches.items():
        paths[path] = {**launches(), **counts}
        expected[path] = launches(raster_embed_batch=2,
                                  raster_extract_batch=2)
    phase("3m", multihost_txt)

    # -- phase 4: golden containers ------------------------------------------
    data = os.path.join(HERE, "tests", "data")
    with open(os.path.join(data, "golden_payload.bin"), "rb") as f:
        golden_payload = f.read()
    goldens = (("hybrid", "golden_image.npy"),
               ("hybrid_packed", "golden_image.npy"),
               ("multi_plane", "golden_image.npy"),
               ("block_adaptive", "golden_image.npy"),
               ("pee", "golden_pee_image.npy"))
    blobs = {}
    for name, _ in goldens:
        with open(os.path.join(data, f"golden_{name}.stgc"), "rb") as f:
            blobs[name] = f.read()
    decs = counted("golden", lambda: {
        name: port.decode_container(blob, device="cuda")
        for name, blob in blobs.items()})
    expected["golden"] = launches(raster_extract=3, pee_extract=2)
    for name, image in goldens:
        golden_img = np.load(os.path.join(data, image))
        check(decs[name].payload == golden_payload,
              f"golden_{name}: payload differs")
        check(np.array_equal(decs[name].original, golden_img),
              f"golden_{name}: original differs")
    phase(4, "golden hybrid / hybrid_packed / multi_plane / block_adaptive / "
             "pee containers decode")

    # -- phase 5: the CLI in subprocesses ------------------------------------
    phase5_cli(parity)
    phase5_cli_volume(vparity)
    phase(5, "CLI encode/decode on the card (hybrid, pee, block_adaptive and "
             "--device-policy host), encode-batch (runner, --fused hybrid "
             "and pee) / decode-batch, encode-volume / decode-volume "
             "--dicom on the 64-slice volume: container, message and "
             "original exact; capacity --json equal to the JAX package's; "
             "analyze, analyze-batch and demo run")

    # -- phase 5s: the serving daemon in a thread of this process ------------
    serve_txt, serve_expected, serve_lat = phase5_serve(
        port, cases.load_parity_serve(), counted, launches, dev)
    expected.update(serve_expected)
    phase("5s", serve_txt)

    # -- phase 6: each path's launches, read right after it ran --------------
    for path, counts in paths.items():
        check(counts == expected[path],
              f"path {path} launched {counts}, expected {expected[path]}")
    totals = {name: sum(counts[name] for counts in paths.values())
              for name in kernel_names}
    check(all(v > 0 for v in totals.values()),
          f"the main path did not launch every kernel: {totals}")
    phase(6, f"launches per path {paths} (each as expected)")

    # -- phase 7: times -------------------------------------------------------
    raster = time_raster(results, dev)
    pee = time_pee(results, dev)
    time_block(results, dev)
    time_routes(port, results)
    batch = time_batch_kernels(device_batches, dev)
    time_batch_walls(port, device_batches)
    time_volume_walls(volume_walls)
    time_dp(port, device_batches, volume_walls, smi, dev)
    band = time_tiled(*tiled_inputs, dev)
    cfg = port.EncodeConfig()

    def cycle_of(name, config):
        img, _, bits, _ = results[name]

        def cycle():
            res = port.encode_array(img, bits, config, bits_stored=12,
                                    device="cuda")
            port.decode_container(res.container, device="cuda")
        return cycle

    cycle_report("raster encode+decode 512x512 u16 (304 bits)",
                 cycle_of("mr512_u16", cfg), 5)
    cycle_report("block encode+decode 512x512 u16 (304 bits)",
                 cycle_of("blk_mr512_u16",
                          port.EncodeConfig(strategy="block_adaptive")), 5)
    cycle_report("pee encode+decode 512x512 u16 (304 bits)",
                 cycle_of("pee_mr512_u16_text", pee_cfg), 5)
    cycle_report("pee encode+decode 2048x2048 u16 (3 Mbit)",
                 cycle_of("pee_cr2048_u16_3m", pee_cfg), 3)
    time_codecs(port, results, smi, dev)
    deflate = time_deflate(smi, dev)
    inflate = time_inflate(smi, dev)
    for op, (wall, daemon_ms) in serve_lat.items():
        print(f"  serve {op} 512x512 u16 (304 bits), warm daemon: "
              f"{wall:.2f} ms request round trip, {daemon_ms:.2f} ms in the "
              f"daemon (median of 5) on {smi}", flush=True)
    phase(7, "times printed above")

    big = raster["2048x2048"]
    rows = (
        ("raster_embed", "raster_embed.cu", "pallas_embed.py:835",
         big["k1"], big["k1_plain"], big["k1_bound"]),
        ("raster_extract", "raster_extract.cu", "pallas_embed.py:897",
         big["k2"], big["k2_plain"], big["k2_bound"]),
        ("pee_embed", "pee_embed.cu", "pallas_pee.py:621",
         pee["k3_pass0"]["ms"], pee["k3_pass0"]["plain_ms"],
         pee["k3_pass0"]["bound"]),
        ("pee_extract", "pee_extract.cu", "pallas_pee.py:781",
         pee["k4_pass1"]["ms"], pee["k4_pass1"]["plain_ms"],
         pee["k4_pass1"]["bound"]),
        ("raster_embed_batch", "raster_embed.cu", "pallas_embed.py:308",
         batch[2048]["k1"], batch[2048]["k1_plain"],
         batch[2048]["k1_bound"]),
        ("raster_extract_batch", "raster_extract.cu", "pallas_embed.py:386",
         batch[2048]["k2"], batch[2048]["k2_plain"],
         batch[2048]["k2_bound"]),
    ) + tuple(
        (name, src, tpu, band[name]["ms"], band[name]["plain_ms"],
         band[name]["bound"])
        for name, src, tpu in (
            ("pee_count_band", "pee_embed.cu", "pallas_pee.py:481"),
            ("pee_embed_band", "pee_embed.cu", "pallas_pee.py:481"),
            ("pee_extract_count_band", "pee_extract.cu", "pallas_pee.py:670"),
            ("pee_extract_band", "pee_extract.cu", "pallas_pee.py:670")))
    # the deflate kernels replace the host zlib of the JAX package's
    # DeflateCodec.encode, which is their library column (per call, 2048x2048)
    big_dfl = deflate["2048x2048"]
    rows += tuple(
        (name, "deflate_rle.cu", "io/codecs/__init__.py:108",
         big_dfl[name]["ms"], None, big_dfl[name]["bound"])
        for name in dfl.KERNELS)
    # the inflate kernels replace host zlib's decode (DeflateCodec.decode)
    big_inf = inflate["2048x2048"]
    rows += tuple(
        (name, "inflate.cu", "io/codecs/__init__.py:139",
         big_inf[name]["ms"], None, big_inf[name]["bound"])
        for name in inf.KERNELS)
    kernels = [
        {"name": name, "route": "cuda",
         "source": f"codec_tcc_tpu_torch/csrc/{src}",
         "replaces": f"codec_tcc_tpu/{'' if '/' in tpu else 'ops/'}{tpu}",
         "launches": totals[name],
         "launches_by_path": {path: counts[name]
                              for path, counts in paths.items()
                              if name in counts},
         "max_abs_err": max_err[name],
         "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd[0],
         "bound_by": bnd[1],
         "library_ms": (big_dfl[name]["library_ms"] if name in dfl.KERNELS
                        else big_inf[name]["library_ms"]
                        if name in inf.KERNELS else None)}
        for name, src, tpu, ms, plain_ms, bnd in rows
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
