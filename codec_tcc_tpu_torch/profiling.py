# Port of codec_tcc_tpu/profiling.py: stage() is a torch.profiler
# record_function range plus a wall clock; trace_to() wraps torch.profiler.
"""Tracing / profiling hooks.

* ``stage(name)``   — context manager: a ``torch.profiler.record_function``
  range (so the stage shows up in a ``torch.profiler`` trace) plus
  wall-clock capture into the process profiler;
* ``Profiler``      — accumulates per-stage wall times and emits a report;
* ``trace_to(dir)`` — captures a ``torch.profiler`` trace (CPU, and CUDA
  when a GPU is present) as a Chrome/Perfetto JSON file (the CLI exposes
  ``--profile-dir``).

Stage wall times are host clocks: a stage that ends without reading a
device result back measures the enqueue, not the device work.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional

from .utils.logging import get_logger

logger = get_logger("profiling")


class Profiler:
    def __init__(self) -> None:
        self.wall: Dict[str, float] = defaultdict(float)
        self.calls: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        from torch.profiler import record_function

        t0 = time.perf_counter()
        with record_function(name):
            yield
        dt = time.perf_counter() - t0
        self.wall[name] += dt
        self.calls[name] += 1

    def reset(self) -> None:
        self.wall.clear()
        self.calls.clear()

    def report(self) -> Dict[str, Dict[str, float]]:
        return {
            name: {
                "wall_s": self.wall[name],
                "calls": self.calls[name],
                "mean_ms": 1e3 * self.wall[name] / max(1, self.calls[name]),
            }
            for name in sorted(self.wall)
        }

    def log_report(self) -> None:
        for name, row in self.report().items():
            logger.info(
                "%-24s %8.1f ms total  %5d calls  %8.2f ms/call",
                name, 1e3 * row["wall_s"], int(row["calls"]), row["mean_ms"],
            )


_global_profiler: Optional[Profiler] = None


def get_profiler() -> Profiler:
    global _global_profiler
    if _global_profiler is None:
        _global_profiler = Profiler()
    return _global_profiler


@contextlib.contextmanager
def stage(name: str) -> Iterator[None]:
    with get_profiler().stage(name):
        yield


@contextlib.contextmanager
def trace_to(profile_dir: Optional[str]) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace into ``profile_dir/trace.json``."""
    if not profile_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    path = os.path.join(profile_dir, "trace.json")
    prof.export_chrome_trace(path)
    logger.info("profile trace written to %s", path)
