#!/usr/bin/env python3
"""Runs one cell several times, one process a run, and reports each
metric's values, median and spread (the distance between the quartiles as
a share of the median), the way the bounds in ``BENCHMARK.json`` were set.

    python3 portbench/sets.py --workload <cell> --seeds 11,12,13 \
        --seconds 40 [--trace 1] [--out chiprun_out/<file>.jsonl]

Prints the card's name and power limit and the host's core count first.
Each run's result line, exit code and wall time go to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)

from portbench.stats import spread  # noqa: E402


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi failed: {exc}"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out")
    args = ap.parse_args()
    print(f"card: {card()}; cores: {os.cpu_count()}", flush=True)
    values: dict = {}
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.time()
        proc = subprocess.run(
            [sys.executable, os.path.join(HERE, "run.py"), "--workload",
             args.workload, "--seed", str(seed), "--seconds",
             str(args.seconds), "--trace", str(args.trace)],
            capture_output=True, text=True, cwd=ROOT)
        wall = time.time() - t0
        lines = proc.stdout.strip().splitlines()
        try:
            result = json.loads(lines[-1])
        except (IndexError, json.JSONDecodeError):
            result = None
        row = {"seed": seed, "rc": proc.returncode, "wall_s": wall,
               "result": result, "stderr_tail": proc.stderr[-3000:]}
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                        exist_ok=True)
            with open(args.out, "a", encoding="utf-8") as f:
                f.write(json.dumps(row) + "\n")
        if result is None:
            print(f"seed {seed}: rc {proc.returncode}, no result\n"
                  f"{proc.stderr[-3000:]}", flush=True)
            continue
        for name, m in result["metrics"].items():
            values.setdefault(name, []).append(m["value"])
        checks = {k: v["value"] for k, v in result.get("checks", {}).items()}
        print(f"seed {seed}: rc {proc.returncode} wall {wall:.1f} s correct "
              f"{result['correct']} requests {result.get('requests')} "
              f"failed {result['failed']} metrics "
              f"{ {k: m['value'] for k, m in result['metrics'].items()} } "
              f"device {result['device']} checks {checks}", flush=True)
        if "breakdown" in result:
            print(f"  breakdown {json.dumps(result['breakdown'])}", flush=True)
    for name, vals in values.items():
        extra = f" spread {spread(vals):.5f}" if len(vals) >= 2 else ""
        print(f"{name}: median {statistics.median(vals)!r}{extra} values "
              f"{vals}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
