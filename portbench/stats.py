"""The arithmetic of the end-to-end metrics, over every request of the
window: percentiles of the request times, and rates over the window."""

from __future__ import annotations

import math
import statistics
from typing import Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """Nearest-rank ``q``-th percentile: the smallest value with at least
    ``q`` percent of the values at or below it."""
    ranked = sorted(values)
    return ranked[max(0, math.ceil(q / 100.0 * len(ranked)) - 1)]


def spread(values: Sequence[float]) -> float:
    """Distance between the first and third quartiles (Python's
    ``statistics.quantiles``) as a share of the median."""
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


class Context:
    """What the metric readers read: the window's requests, the program's
    stage walls, the set-up time and, in a traced run, the trace's summary
    and the traced requests' work."""

    def __init__(self, *, setup_s, window_s, durations, pixels,
                 container_bytes, stages, trace=None, work=None):
        self.setup_s = setup_s
        self.window_s = window_s
        self.durations = list(durations)
        self.pixels = list(pixels)
        self.container_bytes = list(container_bytes)
        self.stages = dict(stages)
        self.trace = trace
        self.work = work

    @property
    def requests(self) -> int:
        return len(self.durations)

    def stage_ms(self, names) -> float | None:
        """Mean wall milliseconds per request of the named program stages
        that ran; None when none did."""
        ran = [self.stages[n] for n in names if n in self.stages]
        if not ran or not self.requests:
            return None
        return 1e3 * sum(ran) / self.requests

    def idle_percent(self) -> float | None:
        if not self.trace:
            return None
        return 100.0 * (1.0 - self.trace["busy_s"] / self.trace["window_s"])
