#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``codec_tcc_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Drives the port's default encode/decode path through its two hand-written
CUDA kernels (K1 ``raster_embed``, K2 ``raster_extract``) and checks it,
phase by phase; any failure exits non-zero:

1. prints the card's name and power limit (``nvidia-smi``), builds the
   kernels from ``codec_tcc_tpu_torch/csrc`` with ``nvcc`` (sm_90a);
2. K1/K2 against their plain torch versions on the card, exact, at
   512x512 / 2048x2048 / 480x640 uint16 and 500x501 uint8, s in {1, 4, 8},
   with wrapping, aliased and past-s windows;
3. every case of ``tests/data/torch_port_parity.json`` through
   ``encode_array(device="cuda")``: the container's sha256 must equal the
   JAX package's, ``decode_container(device="cuda")`` must give the payload
   back and the restored original must be exact;
4. the committed golden raster containers decode on the card;
5. ``python -m codec_tcc_tpu_torch encode`` / ``decode`` as subprocesses on
   a DICOM written by the port: message and restored pixels exact;
6. the launch counts of K1 and K2 over phases 3-4 (the main path) are > 0;
7. times, printed and not asserted: per call of K1/K2 and of their plain
   versions at the main path's 512x512 and 2048x2048 uint16 plans (median
   of 20 CUDA-event reps, wrapper included; and device time alone from
   ``torch.profiler``), and one warm encode+decode at 512x512 (host wall,
   stage means, device busy share).

Before the last line it prints the ``nvidia-smi`` line and one JSON line
``{"kernels": [...]}``; the last line is
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


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def phase(n: int, msg: str) -> None:
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
    total_us = sum(
        evt.self_device_time_total for evt in prof.key_averages()
        if evt.device_type == DeviceType.CUDA
    )
    return total_us / 1e3 / reps if total_us > 0 else None


def fmt_ms(v) -> str:
    return "not measured" if v is None else f"{v:.4f} ms"


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


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a GPU")
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.join(HERE, "tests"))
    import codec_tcc_tpu_torch as port
    import torch_port_cases as cases
    from codec_tcc_tpu_torch import pipeline
    from codec_tcc_tpu_torch.io import dicom
    from codec_tcc_tpu_torch.ops import raster_kernels as rk
    from codec_tcc_tpu_torch.ops.decompose import decompose
    from codec_tcc_tpu_torch.ops.segments import usable_capacity_bits
    from codec_tcc_tpu_torch.profiling import get_profiler

    dev = torch.device("cuda")

    # -- phase 1: card, build ------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    t0 = time.perf_counter()
    lib_path = rk.build_library()
    rk._library()
    phase(1, f"kernels built in {time.perf_counter() - t0:.2f} s -> "
             f"{os.path.relpath(lib_path, HERE)}")

    # -- phase 2: kernels vs plain versions on the card ----------------------
    rng = np.random.default_rng(2024)
    max_err = {"raster_embed": 0, "raster_extract": 0}
    for h, w, dt in ((512, 512, np.uint16), (2048, 2048, np.uint16),
                     (480, 640, np.uint16), (500, 501, np.uint8)):
        n = h * w
        hi = 1 << (8 * np.dtype(dt).itemsize)
        img = torch.from_numpy(rng.integers(0, hi, (h, w)).astype(dt)).to(dev)
        msg = torch.from_numpy(
            rng.integers(0, 2, 5 * n).astype(np.uint8)).to(dev)
        for s, starts, lens, offs in kernel_vs_plain_cases(rng, n):
            emit = n % 8 == 0
            st_k, mp_k = rk.raster_embed(img, msg, starts, lens, offs, s,
                                         emit_maps=emit)
            torch.cuda.synchronize()
            st_p, mp_p = rk.raster_embed_plain(img, msg, starts, lens, offs,
                                               s, emit_maps=emit)
            err = int((st_k.to(torch.int32) - st_p.to(torch.int32))
                      .abs().max())
            if emit:
                err = max(err, int((mp_k.to(torch.int32)
                                    - mp_p.to(torch.int32)).abs().max()))
            max_err["raster_embed"] = max(max_err["raster_embed"], err)
            check(err == 0, f"K1 != plain at {h}x{w} {dt.__name__} s={s}")
            out_len = int(max(int(o) + int(ln) for o, ln in zip(offs, lens)))
            ex_k = rk.raster_extract(st_k, starts, lens, offs, s, out_len)
            torch.cuda.synchronize()
            ex_p = rk.raster_extract_plain(st_k, starts, lens, offs, s, out_len)
            err = int((ex_k.to(torch.int32) - ex_p.to(torch.int32)).abs().max())
            max_err["raster_extract"] = max(max_err["raster_extract"], err)
            check(err == 0, f"K2 != plain at {h}x{w} {dt.__name__} s={s}")
    phase(2, f"K1/K2 == plain on the card (max abs err {max_err})")

    # -- phase 3: the parity cases through the main path ---------------------
    parity = cases.load_parity()
    rk.reset_launch_counts()
    results = {}
    for case in cases.CASES:
        want = parity[case.name]
        img = cases.image(case)
        s = decompose(torch.from_numpy(img).to(dev), 0.4, case.bits_stored).s
        bits = cases.payload_bits(case, usable_capacity_bits(s, img.size, 42))
        check(cases.sha256(bits) == want["payload_sha256"],
              f"{case.name}: payload differs from the fixture's")
        res = port.encode_array(
            img, bits, port.EncodeConfig(strategy=case.strategy),
            bits_stored=case.bits_stored, device="cuda",
        )
        check(res.s == want["s"], f"{case.name}: s={res.s} != {want['s']}")
        check(cases.sha256(res.container) == want["container_sha256"],
              f"{case.name}: container differs from the JAX package's")
        dec = port.decode_container(res.container, device="cuda")
        check(np.array_equal(dec.payload_bits, bits),
              f"{case.name}: decoded payload differs")
        check(dec.original is not None and np.array_equal(dec.original, img),
              f"{case.name}: restored original differs")
        results[case.name] = (img, bits, res)
        print(f"  {case.name}: s={res.s} payload={bits.size} bits "
              f"container={len(res.container)} B sha256 ok, decode ok")
    phase(3, f"{len(cases.CASES)} parity cases byte-identical to the JAX "
             f"package, decoded and restored exactly")

    # -- phase 4: golden containers ------------------------------------------
    data = os.path.join(HERE, "tests", "data")
    golden_img = np.load(os.path.join(data, "golden_image.npy"))
    with open(os.path.join(data, "golden_payload.bin"), "rb") as f:
        golden_payload = f.read()
    for name in ("hybrid", "hybrid_packed", "multi_plane"):
        with open(os.path.join(data, f"golden_{name}.stgc"), "rb") as f:
            dec = port.decode_container(f.read(), device="cuda")
        check(dec.payload == golden_payload, f"golden_{name}: payload differs")
        check(np.array_equal(dec.original, golden_img),
              f"golden_{name}: original differs")
    phase(4, "golden hybrid / hybrid_packed / multi_plane containers decode")

    # -- phase 6 (counts of the main path, read right after it) --------------
    launches = dict(rk.LAUNCHES)

    # -- phase 5: the CLI in subprocesses ------------------------------------
    case = cases.BY_NAME["mr512_u16"]
    img = cases.image(case)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (HERE, env.get("PYTHONPATH")) if p)
    with tempfile.TemporaryDirectory() as tmp:
        dicom.save_image(img, os.path.join(tmp, "in.dcm"),
                         bits_stored=case.bits_stored)
        for args in (["encode", "in.dcm", "out.stgc", "--message",
                      cases.TEXT_PAYLOAD],
                     ["decode", "out.stgc", "--output-prefix", "dec"]):
            proc = subprocess.run(
                [sys.executable, "-m", "codec_tcc_tpu_torch", *args],
                cwd=tmp, env=env, capture_output=True, text=True, timeout=300,
            )
            check(proc.returncode == 0,
                  f"CLI {args[0]} failed:\n{proc.stdout}\n{proc.stderr}")
        with open(os.path.join(tmp, "out.stgc"), "rb") as f:
            check(cases.sha256(f.read())
                  == parity["mr512_u16"]["container_sha256"],
                  "CLI container differs from the JAX package's")
        with open(os.path.join(tmp, "dec_message.txt"), encoding="utf-8") as f:
            check(f.read() == cases.TEXT_PAYLOAD, "CLI message differs")
        restored, _ = dicom.load_image(os.path.join(tmp, "dec_original.dcm"))
        check(np.array_equal(restored, img), "CLI restored pixels differ")
    phase(5, "CLI encode/decode on the card: container, message and "
             "original exact")

    check(launches["raster_embed"] > 0 and launches["raster_extract"] > 0,
          f"the main path did not launch both kernels: {launches}")
    phase(6, f"main-path launches {launches}")

    # -- phase 7: times -------------------------------------------------------
    timing = {}
    for name, label in (("mr512_u16_full", "512x512"),
                        ("cr2048_u16_full", "2048x2048")):
        img, bits, res = results[name]
        meta = res.meta
        n = img.size
        starts, lens, offs = pipeline._plane_plan_from_meta(
            meta, n, pipeline._plane_bucket(meta.s, 16))
        img_d = torch.from_numpy(img).to(dev)
        msg_d = torch.from_numpy(bits).to(dev)
        out_len = int(meta.payload_bits)
        stego_d = torch.from_numpy(res.stego).to(dev)
        row = {
            "k1": cuda_median_ms(lambda: rk.raster_embed(
                img_d, msg_d, starts, lens, offs, meta.s, emit_maps=True)),
            "k1_plain": cuda_median_ms(lambda: rk.raster_embed_plain(
                img_d, msg_d, starts, lens, offs, meta.s, emit_maps=True)),
            "k2": cuda_median_ms(lambda: rk.raster_extract(
                stego_d, starts, lens, offs, meta.s, out_len)),
            "k2_plain": cuda_median_ms(lambda: rk.raster_extract_plain(
                stego_d, starts, lens, offs, meta.s, out_len)),
        }
        dev_row = {
            "k1": device_ms(lambda: rk.raster_embed(
                img_d, msg_d, starts, lens, offs, meta.s, emit_maps=True)),
            "k1_plain": device_ms(lambda: rk.raster_embed_plain(
                img_d, msg_d, starts, lens, offs, meta.s, emit_maps=True)),
            "k2": device_ms(lambda: rk.raster_extract(
                stego_d, starts, lens, offs, meta.s, out_len)),
            "k2_plain": device_ms(lambda: rk.raster_extract_plain(
                stego_d, starts, lens, offs, meta.s, out_len)),
        }
        timing[label] = row
        print(f"  {label} u16 s={meta.s} payload={out_len} bits, per call "
              f"(CUDA events, wrapper included): K1 {row['k1']:.4f} ms "
              f"(plain {row['k1_plain']:.4f} ms), K2 {row['k2']:.4f} ms "
              f"(plain {row['k2_plain']:.4f} ms)")
        print(f"  {label} u16 device time only (profiler): K1 "
              f"{fmt_ms(dev_row['k1'])} (plain {fmt_ms(dev_row['k1_plain'])}),"
              f" K2 {fmt_ms(dev_row['k2'])} "
              f"(plain {fmt_ms(dev_row['k2_plain'])})")
    img, bits, _ = results["mr512_u16"]
    cfg = port.EncodeConfig()

    def cycle():
        res = port.encode_array(img, bits, cfg, bits_stored=12, device="cuda")
        port.decode_container(res.container, device="cuda")

    cycle()
    profiler = get_profiler()
    profiler.reset()
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        cycle()
        walls.append((time.perf_counter() - t0) * 1e3)
    e2e = statistics.median(walls)
    stages = {k: round(v["mean_ms"], 3) for k, v in profiler.report().items()}
    busy = device_ms(cycle, reps=5)
    busy_txt = ("not measured" if busy is None else
                f"{busy:.4f} ms device time = {100 * busy / e2e:.2f}% busy")
    print(f"  encode+decode 512x512 u16 stage means (host wall ms): {stages}")
    phase(7, f"warm encode+decode 512x512 u16 (304 bits): {e2e:.2f} ms host "
             f"wall (median of 5), {busy_txt}")

    big = timing["2048x2048"]
    kernels = [
        {"name": "raster_embed", "route": "cuda",
         "source": "codec_tcc_tpu_torch/csrc/raster_embed.cu",
         "replaces": "codec_tcc_tpu/ops/pallas_embed.py:835",
         "launches": launches["raster_embed"],
         "max_abs_err": max_err["raster_embed"],
         "ms": big["k1"], "plain_ms": big["k1_plain"]},
        {"name": "raster_extract", "route": "cuda",
         "source": "codec_tcc_tpu_torch/csrc/raster_extract.cu",
         "replaces": "codec_tcc_tpu/ops/pallas_embed.py:897",
         "launches": launches["raster_extract"],
         "max_abs_err": max_err["raster_extract"],
         "ms": big["k2"], "plain_ms": big["k2_plain"]},
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
