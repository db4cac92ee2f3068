#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``codec_tcc_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Drives the port's encode/decode paths (raster, PEE, block_adaptive, the
host embed route, the container batch path, the STGV volume path, with
capacity and analyze, and one image split by rows across a mesh) through
its hand-written CUDA kernels (K1 ``raster_embed`` and its batch form
``raster_embed_batch``, K2 ``raster_extract`` and ``raster_extract_batch``,
K3 ``pee_embed``, K4 ``pee_extract`` and their shard mode
``pee_embed_shard``/``pee_extract_shard``) and checks them, phase by
phase; any failure exits non-zero:

1. prints the card's name and power limit (``nvidia-smi``), builds the
   kernels from ``codec_tcc_tpu_torch/csrc`` with ``nvcc`` (sm_90a; one
   compile per source, all at once, linked into one library);
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
   ``blk_*`` cases, with the case's cut point and one lower; then K3/K4 in
   shard mode against their plain band versions on the 2048x2048 uint16
   image of the 3 Mbit PEE case at its T, over 4 bands (pass 0 saturated
   and at half its capacity, pass 1 on pass 0's stego): every band's
   outputs exact, the used count and boundary exact, the bands stitched
   together equal to the whole-image K3/K4;
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
6. the launch counts of each path, set to 0 just before it and read just
   after it: the raster cases (K1 and K2 once per encode and decode), the
   PEE cases and the PEE batch (K3 twice per equal-T attempt group, K4
   twice per decode group), the block cases (no kernel: torch ops to
   encode, the host to decode), the host-route cases (no K1, K2 once per
   decode), the golden decodes and the batch paths (one batch K1 per
   device-route batch encode, one batch K2 per ``extract_batch``, none for
   the host and block batches and the batch decode), the volumes (one
   batch K1 per raster volume encode, one batch K2 per ``extract_volume``,
   none for a raster or block ``unpack_volume``, K3 twice per equal-T
   attempt group of the PEE volume, K4 twice per decode group), the
   capacity probes (K3 twice each), analyze (none), the F1 batch (as the
   PEE batch) and the tiled paths (shard K3 once per band per pass per
   attempt, replayed from the start and final T, shard K4 once per band
   per inverse pass; no kernel for the tiled raster path); every count must be
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
   device, queued with L2 flushed, bound); the tiled PEE encode and decode
   walls at 2048x2048 for K = 1, 2, 4 beside the single-device ones, and
   K3/K4 in shard mode band by band at K = 4 on the case's four passes
   (per call, device, plain, the band's bound) with the band's eligible
   count (torch ops).

Before the last line it prints the ``nvidia-smi`` line and one JSON line
``{"kernels": [...]}`` (per kernel: launches, launches by path, max abs
error, times, and the bound: the larger of its bytes over 3.35 TB/s and its
integer operations over 67 TOP/s, from this run's shapes); the last line is
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
        bases = pipeline._block_bases(torch.from_numpy(img), kbits, s, block,
                                      h, w)
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
    over all of them mixed (host decode, no launch) gives the payloads and
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
            # raster and block slices decode on the host
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

    # the committed golden block_adaptive volume (host decode: no launch)
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
    bases = pipeline._block_bases(img_d, kbits, s, block, h, w)
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
    """K3/K4 in shard mode against their plain band versions on the card:
    the 2048x2048 uint16 image of the 3 Mbit PEE case at its T, split into
    4 bands, pass 0 at the whole payload (saturated) and at half its
    capacity (the boundary inside a band), pass 1 on the saturated pass's
    stego at the rest of the payload; each inverted by K4. Exact: every
    band's stego, overflow, count and nproc (K3) and restored band, bits
    and nbits (K4); the used count and the pass boundary; the four bands
    stitched together against the whole-image K3/K4. Updates ``max_err``;
    returns the text for phase 2."""
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

    cap0 = int(pk.pee_embed(img, msg, i32(0), i32(0), 0, t, max_val)[4][0])
    s0, _, u0, _, _ = pk.pee_embed(img, msg, i32(0), i32(total), 0, t,
                                   max_val)
    used0 = int(u0[0])
    runs = ((img, 0, total, 0), (img, 0, cap0 // 2, 0),
            (s0, used0, total - used0, 1))
    for src, base, want, par in runs:
        what = f"2048x2048 T={t} parity={par} want={want} over {k} bands"
        got, (stego, over, used, nproc) = tiles.embed(
            pk.pee_embed, src, msg, base, want, par, t, max_val, k)
        ref, _ = tiles.embed(pk.pee_embed_plain, src, msg, base, want, par,
                             t, max_val, k)
        torch.cuda.synchronize()
        err = max(max_abs_diff(g, r) for g, r in zip(got, ref))
        max_err["pee_embed_shard"] = max(max_err["pee_embed_shard"], err)
        check(err == 0, f"K3 shard mode != plain at {what}")
        whole = pk.pee_embed(src, msg, i32(base), i32(want), par, t, max_val)
        check(max_abs_diff((stego, over), whole[:2]) == 0
              and (used, nproc) == (int(whole[2][0]), int(whole[3][0]))
              and sum(int(g[2][0]) for g in got) == int(whole[4][0]),
              f"K3 shard bands stitched != whole-image K3 at {what}")
        got, (restored, bits_k, n_bits) = tiles.extract(
            pk.pee_extract, stego, over, nproc, par, t, out_len, k)
        ref, _ = tiles.extract(pk.pee_extract_plain, stego, over, nproc, par,
                               t, out_len, k)
        torch.cuda.synchronize()
        err = max(max_abs_diff(g, r) for g, r in zip(got, ref))
        max_err["pee_extract_shard"] = max(max_err["pee_extract_shard"], err)
        check(err == 0, f"K4 shard mode != plain at {what}")
        w_r, w_bits, w_n = pk.pee_extract(stego, over, i32(nproc), par, t,
                                          out_len)
        check(torch.equal(restored, w_r) and torch.equal(restored, src)
              and torch.equal(bits_k, w_bits[0].cpu())
              and n_bits == int(w_n[0]) == used,
              f"K4 shard bands stitched != whole-image K4 at {what}")
    return (f"K3/K4 shard mode == plain at 2048x2048 u16 T={t} over {k} "
            f"bands (pass 0 saturated and at {cap0 // 2}, pass 1 at "
            f"{total - used0}), stitched == whole image")


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
    every decode exact. Returns (text, the launches of each path, the
    encode/decode walls by K)."""
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
    expected = {"pee_embed_shard": 0, "pee_extract_shard": 0}
    walls = {}

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
        # K launches per pass: both passes of every attempt that fell
        # short, then the final attempt's; K per inverse pass
        expected["pee_embed_shard"] += k * (2 * (t_final - t_start) + passes)
        expected["pee_extract_shard"] += k * passes
        walls[(c.name, k)] = (enc_s, dec_s)
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
    return text, {"tiled_pee": expected, "tiled_raster": {}}, (inputs, walls)


def time_tiled(parity, tiled_inputs, dev) -> dict:
    """The tiled PEE path at 2048x2048 u16, 3 Mbit: encode and decode host
    walls for K = 1, 2, 4 (median of 3 after the path's first run) beside
    the single-device ``encode_array``/``decode_container``; then K3/K4 in
    shard mode, band by band at K = 4 on the case's real passes (per call,
    device time, the plain band version, the bound of the band's bytes)
    and the band's eligible count (the torch-op sweep that gives the rank
    prefix). Returns the band times of band 1 for the kernels line."""
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
    for what, (enc, dec) in calls.items():
        walls = []
        for fn in (enc, dec):
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                fn()
                times.append((time.perf_counter() - t0) * 1e3)
            walls.append(statistics.median(times))
        print(f"  tiled PEE 2048x2048 u16 3 Mbit {what}: encode "
              f"{walls[0]:.2f} ms, decode {walls[1]:.2f} ms host wall "
              f"(median of 3)", flush=True)

    t = parity[case.name]["pee_ext"][0]
    k = cases.TILED_BIG_K
    max_val = (1 << case.bits_stored) - 1
    img_d = torch.from_numpy(img).to(dev)[None]
    msg = message_buffer([bits], dev)

    def i32(v):
        return torch.tensor([int(v)], dtype=torch.int32, device=dev)

    s0, o0, u0, n0, _ = pk.pee_embed(img_d, msg, i32(0), i32(bits.size), 0,
                                     t, max_val)
    used0 = int(u0[0])
    s1, o1, u1, n1, _ = pk.pee_embed(s0, msg, u0, i32(bits.size) - u0, 1, t,
                                     max_val)
    over = o0 | o1
    out_len = 1 << max(3, (bits.size - 1).bit_length())
    r1 = pk.pee_extract(s1, over, n1, 1, t, out_len)[0]
    h, w = img.shape
    lh = -(-h // k)
    passes = {
        "k3_pass0": ("embed", img_d, 0, 0, bits.size),
        "k3_pass1": ("embed", s0, 1, used0, bits.size - used0),
        "k4_pass1": ("extract", s1, 1, int(n1[0]), None),
        "k4_pass0": ("extract", r1, 0, int(n0[0]), None),
    }
    band_times = {}
    for key, (kind, src, par, arg, want) in passes.items():
        rank_base = 0
        for b, (a, e) in enumerate(tiles.bands(h, k)):
            top, bot = tiles.halo(src, a, e)
            band = src[:, a:e].contiguous()
            n = band.numel()
            if kind == "embed":
                shard = (top, bot, i32(a), i32(rank_base), h)
                args = (band, msg, i32(arg), i32(want), par, t, max_val)
                kern = (lambda args=args, shard=shard:
                        pk.pee_embed(*args, shard=shard))
                plain = (lambda args=args, shard=shard:
                         pk.pee_embed_plain(*args, shard=shard))
                out = kern()
                count = int(pee_ops.band_eligible_count(
                    band, top, bot, i32(a), par, t, max_val, h)[0])
                # embedded bits of the band: its eligible pixels below want
                emb = max(0, min(count, want - rank_base))
                rank_base += count
                # band read, stego and overflow written, halo rows, bits
                nbytes = 2 * n + 2 * n + n + 4 * w + emb
                sweep = (lambda band=band, top=top, bot=bot, a=a, par=par:
                         pee_ops.band_eligible_count(band, top, bot, i32(a),
                                                     par, t, max_val, h))
            else:
                shard = (top, bot, i32(a), h)
                ov = over[:, a:e].contiguous()
                args = (band, ov, i32(arg), par, t, out_len)
                kern = (lambda args=args, shard=shard:
                        pk.pee_extract(*args, shard=shard))
                plain = (lambda args=args, shard=shard:
                         pk.pee_extract_plain(*args, shard=shard))
                nb = int(kern()[2][0])
                # stego and overflow read, restored written, halo, bits
                nbytes = 2 * n + n + 2 * n + 4 * w + nb
                sweep = None
            row = {"ms": cuda_median_ms(kern),
                   "plain_ms": cuda_median_ms(plain),
                   "dev_ms": device_ms(kern),
                   "bound": bound(nbytes, K3_K4_OPS_PER_PIXEL * n)}
            sweep_txt = ""
            if sweep is not None:
                sweep_txt = (f", the band's eligible count (torch ops) "
                             f"device {fmt_ms(device_ms(sweep))}")
            print(f"  shard {key} band {b} rows {a}-{e} of 2048x2048 "
                  f"u16 T={t}: per call {row['ms']:.4f} ms (plain "
                  f"{row['plain_ms']:.4f} ms), device {fmt_ms(row['dev_ms'])},"
                  f" bound {row['bound'][0]:.4f} ms ({nbytes} B)"
                  f"{sweep_txt}", flush=True)
            if b == 1:
                band_times[key] = row
    return band_times


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
             f"{os.path.relpath(lib_path, HERE)}")

    # -- phase 2: kernels vs plain versions on the card ----------------------
    max_err = phase2_raster(np.random.default_rng(2024), dev)
    k1_err, k1_txt = phase2_k1(dev)
    max_err["raster_embed"] = max(max_err["raster_embed"], k1_err)
    k2_err, k2_txt = phase2_k2(dev)
    max_err["raster_extract"] = max(max_err["raster_extract"], k2_err)
    batch_err, batch_k_txt = phase2_batch(dev)
    max_err.update(batch_err)
    max_err.update(phase2_pee(dev))
    max_err.update(pee_embed_shard=0, pee_extract_shard=0)
    parity = cases.load_parity()
    shard_txt = phase2_pee_shard(dev, parity, max_err)
    stress_txt = phase2_pee_stress(dev)
    block_txt = phase2_block(port, dev)
    phase(2, f"K1-K4, batch K1/K2 and shard K3/K4 == plain on the card (max "
             f"abs err {max_err}); {k1_txt}; {k2_txt}; {batch_k_txt}; "
             f"{shard_txt}; {stress_txt}; {block_txt}")

    # -- phase 3: the parity cases through the main path ---------------------
    # Each path runs with the launch counts set to 0 just before it and is
    # read just after it (phase 6 checks them).
    tparity = cases.load_parity_tiled()
    paths, expected = {}, {}
    kernel_names = tuple(rk.LAUNCHES) + tuple(pk.LAUNCHES)

    def launches(**nonzero):
        """Launches by kernel: 0 for every kernel not named."""
        return {**{name: 0 for name in kernel_names}, **nonzero}

    def counted(path, fn):
        rk.reset_launch_counts()
        pk.reset_launch_counts()
        out = fn()
        paths[path] = {**rk.LAUNCHES, **pk.LAUNCHES}
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
                                  raster_extract=n_path["raster"])
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
                               pee_extract=2 * n_path["pee"])
    # block_adaptive: torch ops on the card to encode, the host to decode
    counted("block", lambda: run_cases("block"))
    expected["block"] = launches()
    # the host embed route: no K1; its containers decode through K2
    counted("host", lambda: run_cases("host"))
    expected["host"] = launches(raster_extract=n_path["host"])
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

    # -- phase 3t: one image across a mesh (the tile axis) -------------------
    tiled_txt, tiled_expected, tiled_inputs = phase3_tiled(
        port, parity, tparity, counted, dev)
    for path, nonzero in tiled_expected.items():
        expected[path] = launches(**nonzero)
    phase("3t", tiled_txt)

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
    shard = time_tiled(parity, tiled_inputs[0], dev)
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
        ("pee_embed_shard", "pee_embed.cu", "pallas_pee.py:481",
         shard["k3_pass0"]["ms"], shard["k3_pass0"]["plain_ms"],
         shard["k3_pass0"]["bound"]),
        ("pee_extract_shard", "pee_extract.cu", "pallas_pee.py:670",
         shard["k4_pass1"]["ms"], shard["k4_pass1"]["plain_ms"],
         shard["k4_pass1"]["bound"]),
    )
    kernels = [
        {"name": name, "route": "cuda",
         "source": f"codec_tcc_tpu_torch/csrc/{src}",
         "replaces": f"codec_tcc_tpu/ops/{tpu}",
         "launches": totals[name],
         "launches_by_path": {path: counts[name]
                              for path, counts in paths.items()},
         "max_abs_err": max_err[name],
         "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd[0],
         "bound_by": bnd[1], "library_ms": None}
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
