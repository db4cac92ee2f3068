"""Reads a ``torch.profiler`` Chrome trace of the traced slice of a run.

* the host ranges: the program's ``profiling.stage`` ranges and the
  harness's own request spans (``portbench.*``), all ``user_annotation``
  events of one thread, properly nested;
* the device operations: kernels, copies and memsets, each tied to the
  host range open when it was launched, through the ``correlation`` id it
  shares with its runtime or driver call;
* the traced window: from the first harness span's start to the last
  one's end.

From these: the seconds the device was busy (the union of its
operations), the device seconds of kernels and memsets launched inside
each named range, the operations that took most time, and the idle gaps
named by the innermost range open on the host.
"""

from __future__ import annotations

import bisect
import json
import re
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HARNESS_PREFIX = "portbench."
IDLE_OUTSIDE = "outside_requests"


def _segments(ranges: List[Tuple[float, float, str]]):
    """The timeline cut where the set of open ranges changes: ``(starts,
    stacks)``, ``stacks[i]`` the names open from ``starts[i]`` on, outermost
    first."""
    starts, stacks, stack = [], [], []

    def mark(t):
        starts.append(t)
        stacks.append(tuple(name for _, name in stack))

    for s, e, name in sorted(ranges, key=lambda r: (r[0], -r[1])):
        while stack and stack[-1][0] <= s:
            end = stack.pop()[0]
            mark(end)
        stack.append((e, name))
        mark(s)
    while stack:
        mark(stack.pop()[0])
    return starts, stacks


def _open_at(starts, stacks, t: float) -> tuple:
    i = bisect.bisect_right(starts, t) - 1
    return stacks[i] if i >= 0 else ()


def _split_gap(starts, stacks, g0: float, g1: float, gaps: dict) -> None:
    """Adds the idle interval ``[g0, g1)`` to ``gaps`` by the innermost
    host range open over each part of it."""
    cuts = ([g0] + starts[bisect.bisect_right(starts, g0):
                          bisect.bisect_left(starts, g1)] + [g1])
    for a, b in zip(cuts, cuts[1:]):
        stack = _open_at(starts, stacks, a)
        name = stack[-1] if stack else IDLE_OUTSIDE
        gaps[name] = gaps.get(name, 0.0) + b - a


def short_name(name: str) -> str:
    """A device operation's name without ``void``, namespaces and template
    or call arguments."""
    if name.startswith(("Memcpy", "Memset")):
        return name.split(" (")[0]
    name = name.replace("(anonymous namespace)::", "")
    base = re.split(r"[<(]", name.replace("void ", "", 1), maxsplit=1)[0]
    return base.split("::")[-1] or name


def analyse(path: str, top: int = 10) -> Dict:
    with open(path, encoding="utf-8") as f:
        events = json.load(f)["traceEvents"]
    ranges, launches, ops = [], {}, []
    tids = {ev.get("tid") for ev in events if ev.get("cat") == "user_annotation"
            and str(ev.get("name", "")).startswith(HARNESS_PREFIX)}
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, ts, dur = ev.get("cat"), float(ev["ts"]), float(ev.get("dur", 0))
        corr = (ev.get("args") or {}).get("correlation")
        if cat == "user_annotation" and ev.get("tid") in tids:
            ranges.append((ts, ts + dur, ev["name"]))
        elif cat in LAUNCH_CATS and corr is not None:
            launches[corr] = ts
        elif cat in DEVICE_CATS:
            ops.append((ts, ts + dur, ev["name"], cat, corr))
    spans = [r for r in ranges if r[2].startswith(HARNESS_PREFIX)]
    if not spans:
        return {}
    w0, w1 = min(r[0] for r in spans), max(r[1] for r in spans)
    starts, stacks = _segments(ranges)

    in_range: Dict[str, float] = {}
    by_op: Dict[str, float] = {}
    unlinked = 0
    intervals = []
    for a, b, name, cat, corr in ops:
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        intervals.append((a, b))
        by_op[short_name(name)] = by_op.get(short_name(name), 0.0) + b - a
        if cat == "gpu_memcpy":
            continue
        t = launches.get(corr)
        if t is None:
            unlinked += 1
            t = a
        for rng in set(_open_at(starts, stacks, t)):
            in_range[rng] = in_range.get(rng, 0.0) + b - a

    busy, gaps, end = 0.0, {}, w0
    for a, b in sorted(intervals) + [(w1, w1)]:
        if a > end:
            _split_gap(starts, stacks, end, a, gaps)
        if b > end:
            busy += b - max(a, end)
            end = b

    def ranked(d):
        return [[k, v * 1e-6] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:top]]

    return {"window_s": (w1 - w0) * 1e-6, "busy_s": busy * 1e-6,
            "range_device_s": {k: v * 1e-6 for k, v in in_range.items()},
            "device_ops": ranked(by_op), "idle_gaps": ranked(gaps),
            "unlinked_ops": unlinked, "device_op_count": len(intervals)}
