#!/usr/bin/env python3
"""The benchmark cell ``ct512_pee.volume256`` (a 256 x 512x512 u16 PEE series
through ``encode_volume``, ``pack_volume`` and ``unpack_volume``) looked
at from inside, on one GPU:

    python3 tools/torch_pee_volume_probe.py --requests 3 --seed 2147500001
    python3 tools/torch_pee_volume_probe.py --lower-seeds 1,2,3 --seconds 3
    python3 tools/torch_pee_volume_probe.py --control-seeds 7,8,9

* ``--requests N``: N requests of the cell's pool (the seed's first
  series, then the second, in turn) through its entry, each with the
  program's counters (attempt groups, escalations, the decode's groups,
  batch encodes and probes, launches, copies), the thresholds its slices
  reached, the reference's split threshold and its stage walls, and every
  count of the benchmark's comparison for the first request.
* ``--lower-seeds``: the port's runs of the cell through the harness
  (``--seconds`` windows, the cell's check sample), each run's
  ``metric_gap`` and counts: the lower reading of the cell's limit.
* ``--control-seeds``: the control's ``metric_gap`` (``reference/control.py``:
  the reference's metrics with bfloat16 moments) on the reference's own PEE
  series, one unit a seed: the upper reading. ``portbench/limits.py`` takes
  the raster reference for every volume, so it cannot read a PEE series.
* ``--depth``: fewer slices than the cell's 256 (a quick first look);
  ``--device cpu`` runs ``--requests`` and ``--control-seeds`` here.

Prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import collections
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CELL = "ct512_pee.volume256"
COUNTERS = ("pee.batch_groups", "pee.batch_escalated", "pee.decode_groups",
            "volume.pee_encodes", "volume.pee_probes", "launch.pee_embed",
            "launch.pee_extract", "pee.map_host", "h2d_bytes", "d2h_bytes")


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi failed: {exc}"


def _cell(depth):
    from portbench import harness

    wl, cfg = harness.load_cell(CELL)
    if depth:
        wl["payload_bits"] = int(wl["payload_bits"]) * depth // wl["depth"]
        wl["depth"] = depth
    return wl, cfg


def requests(n: int, seed: int, depth, device: str) -> None:
    import torch

    from codec_tcc_tpu_torch import profiling
    from portbench.entries import volume_pee
    from portbench.reference import pee_volume, stgc
    from portbench.traffic import generator

    wl, cfg = _cell(depth)
    t0 = time.perf_counter()
    pool = generator.make_pool(cfg, wl, seed)
    print(f"pool of {len(pool)} series {pool[0]['volume'].shape} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    state = volume_pee.prepare(cfg, device)
    prof = profiling.get_profiler()
    for r in range(n):
        unit = pool[r % len(pool)]
        prof.reset()
        if device.startswith("cuda"):
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = volume_pee.request(state, unit)
        wall = time.perf_counter() - t0
        c = profiling.counters()
        ts = collections.Counter(stgc.pee_ext(stgc.parse_stgc(x)["ext"])[0]
                                 for x in out["containers"])
        empty = sum(stgc.parse_stgc(x)["payload_bits"] == 0
                    for x in out["containers"])
        print(f"request {r}: wall {wall * 1e3:.2f} ms, STGV "
              f"{len(out['stgv'])} B, counters "
              f"{ {k: c.get(k, 0) for k in COUNTERS} }, T reached "
              f"{dict(sorted(ts.items()))}, empty slices {empty}", flush=True)
        print(f"  stages ms { {k: round(1e3 * v, 2) for k, v in sorted(prof.wall.items())} }",
              flush=True)
        if r == 0:
            t0 = time.perf_counter()
            judged = volume_pee.judge_unit(pee_volume, cfg, unit, out,
                                           device)
            caps = pee_volume.slice_capacities(unit["volume"], 65535, device)
            t_split, sizes = pee_volume.split(
                caps, int(unit["payloads"][0].size),
                int(cfg["pee_threshold"]), 64)
            print(f"  judged in {time.perf_counter() - t0:.2f} s: {judged}; "
                  f"reference split at T {t_split}, chunks "
                  f"{int(sizes.min())}-{int(sizes.max())}, "
                  f"{int((sizes == 0).sum())} empty", flush=True)
    if device.startswith("cuda"):
        print(f"memory_peak_bytes {torch.cuda.max_memory_allocated()}",
              flush=True)


def lower(seeds, seconds: float, device: str) -> None:
    from portbench import harness

    gaps = []
    for seed in seeds:
        result, checks = harness.run_cell(CELL, seed, seconds, False,
                                          device=device,
                                          t0=time.perf_counter())
        gaps.append(checks["metric_gap"]["value"])
        print(f"program seed {seed}: correct {result['correct']} requests "
              f"{result['requests']} judged {result['judged_units']} "
              f"{ {k: v['value'] for k, v in checks.items()} }", flush=True)
    print(f"lower reading (largest program gap) {max(gaps)!r}", flush=True)


def control(seeds, depth, device: str) -> None:
    from portbench.reference import control as control_mod
    from portbench.reference import judge, pee_volume
    from portbench.traffic import generator

    wl, cfg = _cell(depth)
    wl = dict(wl, pool=1)
    gaps = []
    for seed in seeds:
        unit = generator.make_pool(cfg, wl, seed)[0]
        ref = pee_volume.encode_volume(unit["volume"], unit["payloads"][0],
                                       cfg, device=device)
        gaps.append(judge.metric_gap(
            control_mod.quality(unit["volume"], ref["stego"], device),
            ref["metrics"]))
        print(f"control seed {seed}: metric_gap {gaps[-1]!r} (reference "
              f"split T {ref['T']})", flush=True)
    print(f"upper reading (smallest control gap) {min(gaps)!r}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--requests", type=int, default=0)
    ap.add_argument("--seed", type=int, default=2147500001)
    ap.add_argument("--depth", type=int)
    ap.add_argument("--lower-seeds")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control-seeds")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    print(f"card: {_card()}; cores: {os.cpu_count()}", flush=True)
    if args.requests:
        requests(args.requests, args.seed, args.depth, args.device)
    if args.lower_seeds:
        lower([int(s) for s in args.lower_seeds.split(",")], args.seconds,
              args.device)
    if args.control_seeds:
        control([int(s) for s in args.control_seeds.split(",")], args.depth,
                args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
