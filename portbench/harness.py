"""One run of one cell: set-up, the measured window, the traced slice, the
comparison with the plain reference, and the result line.

Everything is found by name: the cell in ``workloads/<cell>.json``, its
configuration in ``configs/<config>.json``, the entry it drives in
``entries/<entry>.py``, the configuration's reference in
``reference/<reference>.py`` and each metric's reader in
``metrics/<metric>.py``; ``BENCHMARK.json`` says which metrics a cell
reports. A new cell, configuration or metric is new files and entries.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import random
import sys
import tempfile
import time
import traceback
from pathlib import Path

from . import stats, trace as trace_mod
from .reference import judge
from .traffic import generator

ROOT = Path(__file__).resolve().parent.parent
HERE = ROOT / "portbench"
TRACE_SECONDS = 3.0      # the traced slice of the window
BANNED = ("jax", "jaxlib", "flax", "codec_tcc_tpu")
SPAN = trace_mod.HARNESS_PREFIX + "request"


def load_json(path: Path) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def load_cell(name: str):
    """``(workload, configuration)`` of a cell, from their files."""
    wl = load_json(HERE / "workloads" / f"{name}.json")
    return wl, load_json(HERE / "configs" / f"{wl['config']}.json")


def metric_names(bench: dict, cell: str, kind: str) -> list:
    """``(name, unit)`` of the ``end_to_end`` or ``per_layer`` metrics
    ``BENCHMARK.json`` has the cell report."""
    return [(m["name"], m["unit"]) for m in bench[kind]
            if cell in m.get("workloads", [cell])]


def read_metric(name: str, ctx):
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench.metrics." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)


def banned_modules() -> list:
    """Top-level names of loaded modules that belong to JAX or the JAX
    package, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(BANNED))


def _sync(device: str) -> None:
    import torch

    if device.startswith("cuda"):
        torch.cuda.synchronize()


def _cards_used():
    """``(count, peak)``: the cards on which this process allocated device
    memory, and the peak allocation on the fullest of them."""
    import torch

    peaks = [torch.cuda.max_memory_allocated(d)
             for d in range(torch.cuda.device_count())]
    used = [p for p in peaks if p > 0]
    return len(used), max(used, default=0)


def _unit_pixels(unit: dict) -> int:
    return int((unit["volume"] if "volume" in unit else unit["images"]).size)


def _out_bytes(out: dict) -> int:
    if "stgv" in out:
        return len(out["stgv"])
    return sum(len(c) for c in out["containers"])


def _traced_work(containers: list):
    """Work bytes of the traced requests' single-image containers; None
    where they wrote none (a volume)."""
    from .work import container_work

    if not containers:
        return None
    work = {"embed": 0, "extract": 0}
    for c in containers:
        for k, v in container_work(c).items():
            work[k] += v
    return work


def _analyse_profile(prof) -> dict:
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return trace_mod.analyse(path)
    finally:
        os.unlink(path)


def run_cell(cell: str, seed: int, seconds: float, traced: bool, *,
             device: str, t0: float, bench: dict | None = None,
             overrides: dict | None = None):
    """Run ``cell`` once; returns ``(result, checks)``: the result line's
    object, and each compared number with its limit. ``overrides``
    replaces configuration and workload keys (the CPU tests' small
    sizes); ``t0`` is the process's start on ``time.perf_counter``."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from codec_tcc_tpu_torch import profiling
    from codec_tcc_tpu_torch.utils.logging import set_verbosity

    bench = bench or load_json(ROOT / "BENCHMARK.json")
    wl, cfg = load_cell(cell)
    for key, value in (overrides or {}).items():
        (wl if key in wl else cfg)[key] = value
    entry = importlib.import_module(f"portbench.entries.{wl['entry']}")
    ref_mod = importlib.import_module(f"portbench.reference.{cfg['reference']}")
    set_verbosity("WARNING")

    pool = generator.make_pool(cfg, wl, seed)
    state = entry.prepare(cfg, device)
    entry.request(state, pool[0])            # the one warm request
    _sync(device)
    setup_s = time.perf_counter() - t0

    stage_prof = profiling.get_profiler()
    stage_prof.reset()
    rng = random.Random(seed)
    keep = int(wl["check_sample"])
    kept, traced_containers = [], []
    n_traced = 0
    durations, pixels, nbytes = [], [], []
    attempted = failed = 0
    prof = prof_done = None
    if traced:
        acts = [ProfilerActivity.CPU]
        if device.startswith("cuda"):
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.start()
    start = time.perf_counter()
    deadline = start + seconds
    while time.perf_counter() < deadline:
        u = attempted % len(pool)
        attempted += 1
        r0 = time.perf_counter()
        try:
            with record_function(SPAN):
                out = entry.request(state, pool[u])
        except Exception:          # a request that fails counts, the loop goes on
            failed += 1
            if failed <= 3:
                traceback.print_exc()
            continue
        now = time.perf_counter()
        durations.append(now - r0)
        pixels.append(_unit_pixels(pool[u]))
        nbytes.append(_out_bytes(out))
        if prof is not None:
            n_traced += 1
            traced_containers += out.get("containers", [])
            if now - start >= TRACE_SECONDS:
                prof.stop()
                prof_done, prof = prof, None
        n = len(durations)
        if len(kept) < keep:
            kept.append((u, out))
        else:
            j = rng.randrange(n)
            if j < keep:
                kept[j] = (u, out)
    window_s = time.perf_counter() - start
    if prof is not None:
        prof.stop()
        prof_done = prof
    _sync(device)

    cards, peak = _cards_used() if device.startswith("cuda") else (1, 0)
    stages = dict(stage_prof.wall)
    summary = _analyse_profile(prof_done) if traced else None
    ctx = stats.Context(setup_s=setup_s, window_s=window_s,
                        durations=durations, pixels=pixels,
                        container_bytes=nbytes, stages=stages,
                        trace=summary,
                        work=_traced_work(traced_containers) if traced else None)
    kind = "per_layer" if traced else "end_to_end"
    metrics = {}
    for name, unit in metric_names(bench, cell, kind):
        value = read_metric(name, ctx)
        if value is not None:
            metrics[name] = {"value": value, "unit": unit}

    del state, traced_containers
    if device.startswith("cuda"):
        torch.cuda.empty_cache()
    readings = [entry.judge_unit(ref_mod, cfg, pool[u], out, device)
                for u, out in kept]
    numbers = judge.merge(readings) if readings else None
    limits = {k: 0 for k in judge.EXACT}
    limits["metric_gap"] = float(wl["limits"]["metric_gap"])
    checks = {"requests_failed": {"value": failed, "limit": 0},
              "units_unjudged": {"value": 0 if readings else 1, "limit": 0}}
    for k, lim in limits.items():
        v = numbers[k] if numbers else 0
        if isinstance(v, float) and not math.isfinite(v):
            v = 1e300
        checks[k] = {"value": v, "limit": lim}
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    dev = {"platform": "gpu" if device.startswith("cuda") else "cpu",
           "kind": (torch.cuda.get_device_name(0) if device.startswith("cuda")
                    else "cpu"),
           "count": cards, "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if traced and summary:
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
        print(f"portbench: traced {n_traced} requests of the "
              f"window's first {TRACE_SECONDS} s; {summary['device_op_count']} "
              f"device ops, {summary['unlinked_ops']} without a launch "
              f"record", file=sys.stderr)
    result["requests"] = len(durations)
    result["window_s"] = window_s
    result["judged_units"] = len(readings)
    result["checks"] = checks
    return result, checks
