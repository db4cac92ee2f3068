#!/usr/bin/env python3
"""The readings a cell's ``metric_gap`` limit is set from, in one process:

* the lower reading: the port's runs (a short window each, the cell's own
  sizes and check sample) on a dozen seeds or more, their largest gap;
* the upper reading: the control (``reference/control.py``, the reference
  with bfloat16 metric moments in the port's place) on the same number of
  units per seed as a run judges, on three seeds or more, its smallest.

    python3 portbench/limits.py --workload <cell> --seeds 1,2,... \
        --control-seeds 7,8,9 --seconds 3
"""

from __future__ import annotations

import argparse
import importlib
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def control_gap(cell: str, seed: int, device: str) -> float:
    from portbench import harness
    from portbench.reference import control, judge, raster
    from portbench.traffic import generator

    wl, cfg = harness.load_cell(cell)
    ref_mod = importlib.import_module(f"portbench.reference.{cfg['reference']}")
    gaps = []
    for unit in generator.make_pool(cfg, wl, seed)[:int(wl["check_sample"])]:
        if "volume" in unit:
            ref = raster.encode_volume(unit["volume"], unit["payloads"][0], cfg)
            pairs = [(unit["volume"], ref["stego"], ref["metrics"])]
        else:
            pairs = []
            for img, bits in zip(unit["images"], unit["payloads"]):
                ref = ref_mod.encode_image(img, bits, cfg, device=device)
                pairs.append((img, ref["stego"], ref["metrics"]))
        for img, stego, want in pairs:
            gaps.append(judge.metric_gap(control.quality(img, stego, device),
                                         want))
    return max(gaps)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args()
    from portbench import harness

    lower, upper = [], []
    for seed in (int(s) for s in args.seeds.split(",")):
        result, checks = harness.run_cell(
            args.workload, seed, args.seconds, False, device="cuda",
            t0=time.perf_counter())
        lower.append(checks["metric_gap"]["value"])
        print(f"program seed {seed}: correct {result['correct']} requests "
              f"{result['requests']} judged {result['judged_units']} "
              f"{ {k: v['value'] for k, v in checks.items()} }", flush=True)
    for seed in (int(s) for s in args.control_seeds.split(",")):
        upper.append(control_gap(args.workload, seed, "cuda"))
        print(f"control seed {seed}: metric_gap {upper[-1]!r}", flush=True)
    print(f"{args.workload}: lower reading (largest program gap) "
          f"{max(lower)!r}; upper reading (smallest control gap) "
          f"{min(upper)!r}; ratio {min(upper) / max(lower):.1f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
