# Port of codec_tcc_tpu/profiling.py: stage() is a span (a torch.profiler
# record_function range while tracing is on, plus a wall clock); the port
# adds requests, parents, self time, copy bytes and one counter registry.
"""Spans and counters: the package's one instrument.

* ``stage(name)`` — context manager, a **span**: its name, a span id, the
  id of its parent (the innermost span open on the same thread), a request
  id, start and end on ``time.perf_counter_ns()`` and the host-to-device
  and device-to-host bytes copied while it was the innermost span. A span
  opened with no span open starts a new request;
* ``request(name)`` — a span that always starts a new request, so that a
  caller can group several entry calls under one request id (``serve``
  opens one per socket request);
* ``entry`` — decorator: the entry points' own spans, named after the
  function; their self time is the host shell that no stage names;
* ``count(name, n)`` / ``counters()`` — the process-global counter
  registry: ``launch.<kernel>`` per kernel launch, ``h2d_bytes`` and
  ``d2h_bytes`` per copy (:mod:`.device` counts them), ``spans_dropped``,
  per block fill ``block.tiles_ranked`` and ``block.bits_placed``, and
  ``block.decode_device`` per single-image block decode whose fill runs on
  a CUDA device (:mod:`.pipeline`); per deflate stream the codec encodes or
  decodes, the side that did it (``codec.deflate_device`` /
  ``codec.deflate_host``, ``codec.inflate_device`` / ``codec.inflate_host``)
  and, per stream inflated on the card, ``inflate.blocks`` and
  ``inflate.serial_blocks`` (:mod:`.ops.deflate_rle`, :mod:`.ops.inflate`);
  per PEE decode, where its overflow map was expanded: ``pee.map_device``
  (packed up, expanded on a CUDA device) or ``pee.map_host`` (expanded on
  the host: a CPU device, or a container of a batch decode)
  (:mod:`.models.pee`, :mod:`.parallel.batch_pee`); per PEE batch,
  ``pee.batch_groups`` (equal-T attempt groups), ``pee.batch_escalated``
  (images re-queued at T + 1) and ``pee.decode_groups`` (K4 groups of a
  decode) (:mod:`.parallel.batch_pee`); per PEE volume encode,
  ``volume.pee_encodes`` (batch encodes of its splits) and
  ``volume.pee_probes`` (exact capacity probes) (:mod:`.parallel.volume`);
* ``Profiler`` — per-name wall, self time, calls and copy bytes, always
  on; ``reset()`` zeroes them with the counters and the span log;
* ``trace_to(dir)`` — captures a ``torch.profiler`` trace (CPU, and CUDA
  when a GPU is present) as a Chrome/Perfetto JSON file with the span log
  in it (the CLI exposes ``--profile-dir``).

Always on: the per-name sums and the counters. Only while tracing is on (a
``torch.profiler`` session is active, or after :func:`enable`): the
``record_function`` range of each span and the span log, a ring of the
last :data:`RING_SIZE` finished spans (older ones are dropped and counted
in ``spans_dropped``).

Span walls are host clocks: a span that ends without reading a device
result back measures the enqueue, not the device work. The sums and
counters take no lock: spans and copies run on the caller's thread
(the package's zlib worker threads open none).
"""

from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import json
import os
import statistics
import threading
import time
from typing import Dict, Iterator, List, Optional

import torch.autograd.profiler as _autograd_profiler

from .utils.logging import get_logger

logger = get_logger("profiling")

RING_SIZE = 65536

_counters: Dict[str, int] = {}
_tls = threading.local()
_span_ids = itertools.count(1)
_request_ids = itertools.count(1)
_enabled = False


def count(name: str, n: int = 1) -> None:
    """Adds ``n`` to the process-global counter ``name``."""
    _counters[name] = _counters.get(name, 0) + n


def counters() -> Dict[str, int]:
    """A copy of the counter registry."""
    return dict(_counters)


def launches(kernels) -> Dict[str, int]:
    """The ``launch.<kernel>`` counters of ``kernels``, by kernel name."""
    return {k: _counters.get("launch." + k, 0) for k in kernels}


def enable() -> None:
    """Tracing on, whether or not a ``torch.profiler`` session is active."""
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def tracing() -> bool:
    """Whether spans open their ``record_function`` range and are logged."""
    return _enabled or _autograd_profiler._is_profiler_enabled


def _stack() -> list:
    try:
        return _tls.stack
    except AttributeError:
        _tls.stack = []
        return _tls.stack


def copied(counter: str, nbytes: int) -> None:
    """A copy of ``nbytes`` between host and device: added to ``counter``
    (``h2d_bytes`` or ``d2h_bytes``) and to the innermost open span."""
    _counters[counter] = _counters.get(counter, 0) + nbytes
    stack = _stack()
    if stack:
        span = stack[-1]
        if counter == "h2d_bytes":
            span.h2d_bytes += nbytes
        else:
            span.d2h_bytes += nbytes


class Span:
    """One timed region; see the module docstring."""

    __slots__ = ("name", "profiler", "new_request", "span_id", "parent_id",
                 "request_id", "t0", "t1", "child_ns", "h2d_bytes",
                 "d2h_bytes", "tid", "_range")

    def __init__(self, name: str, profiler: "Profiler",
                 new_request: bool = False) -> None:
        self.name = name
        self.profiler = profiler
        self.new_request = new_request
        self.t1 = 0

    def __enter__(self) -> "Span":
        stack = _stack()
        parent = stack[-1] if stack else None
        self.span_id = next(_span_ids)
        self.parent_id = parent.span_id if parent is not None else 0
        self.request_id = (next(_request_ids)
                           if self.new_request or parent is None
                           else parent.request_id)
        self.child_ns = self.h2d_bytes = self.d2h_bytes = 0
        self._range = None
        stack.append(self)
        self.t0 = time.perf_counter_ns()
        if _enabled or _autograd_profiler._is_profiler_enabled:
            # the range opens after the clock: its trace event starts a
            # few microseconds after t0, whatever its first call costs
            self.tid = threading.get_native_id()
            self._range = _autograd_profiler.record_function(self.name)
            self._range.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        traced = self._range is not None
        if traced:
            self._range.__exit__(*exc)
            self._range = None
        self.t1 = t1 = time.perf_counter_ns()
        stack = _stack()
        stack.pop()
        wall = t1 - self.t0
        if stack:
            stack[-1].child_ns += wall
        self.profiler._add(self, wall)
        if traced:
            self.profiler._log(self)
        return False

    @property
    def wall_ns(self) -> int:
        return self.t1 - self.t0

    @property
    def wall_ms(self) -> float:
        return 1e-6 * (self.t1 - self.t0)

    @property
    def self_ns(self) -> int:
        return self.t1 - self.t0 - self.child_ns


class Profiler:
    """Per-name sums of the spans' walls, self times, calls and copy
    bytes, and the span log."""

    def __init__(self, ring_size: int = RING_SIZE) -> None:
        # name -> [wall_ns, self_ns, calls, h2d_bytes, d2h_bytes]
        self._sums: Dict[str, list] = {}
        self.spans: collections.deque = collections.deque(maxlen=ring_size)

    def stage(self, name: str) -> Span:
        return Span(name, self)

    def request(self, name: str) -> Span:
        return Span(name, self, new_request=True)

    def _add(self, span: Span, wall: int) -> None:
        acc = self._sums.get(span.name)
        if acc is None:
            acc = self._sums[span.name] = [0, 0, 0, 0, 0]
        acc[0] += wall
        acc[1] += wall - span.child_ns
        acc[2] += 1
        acc[3] += span.h2d_bytes
        acc[4] += span.d2h_bytes

    def _log(self, span: Span) -> None:
        if len(self.spans) == self.spans.maxlen:
            count("spans_dropped")
        self.spans.append(span)

    @property
    def wall(self) -> Dict[str, float]:
        """Seconds per span name."""
        return {k: 1e-9 * v[0] for k, v in self._sums.items()}

    @property
    def self_wall(self) -> Dict[str, float]:
        """Self seconds per span name: walls less their child spans'."""
        return {k: 1e-9 * v[1] for k, v in self._sums.items()}

    @property
    def calls(self) -> Dict[str, int]:
        return {k: v[2] for k, v in self._sums.items()}

    def reset(self) -> None:
        """Zeroes the sums, the span log and the counter registry."""
        self._sums.clear()
        self.spans.clear()
        _counters.clear()

    def report(self) -> Dict[str, Dict[str, float]]:
        return {
            name: {
                "wall_s": 1e-9 * v[0],
                "self_s": 1e-9 * v[1],
                "calls": v[2],
                "mean_ms": 1e-6 * v[0] / max(1, v[2]),
                "h2d_bytes": v[3],
                "d2h_bytes": v[4],
            }
            for name, v in sorted(self._sums.items())
        }

    def log_report(self) -> None:
        for name, row in self.report().items():
            logger.info(
                "%-24s %8.1f ms total  %8.1f ms self  %5d calls  %8.2f "
                "ms/call  %10d B h2d  %10d B d2h",
                name, 1e3 * row["wall_s"], 1e3 * row["self_s"],
                int(row["calls"]), row["mean_ms"], row["h2d_bytes"],
                row["d2h_bytes"],
            )
        for name, n in sorted(counters().items()):
            logger.info("%-24s %12d", name, n)
        # the span log, as trees: each span under its parent
        depth: Dict[int, int] = {}
        for span in sorted(self.spans, key=lambda s: s.t0):
            depth[span.span_id] = depth.get(span.parent_id, -1) + 1
            logger.info(
                "request %-5d %s%-24s %8.3f ms  %8.3f ms self  %10d B h2d  "
                "%10d B d2h", span.request_id, "  " * depth[span.span_id],
                span.name, 1e-6 * span.wall_ns, 1e-6 * span.self_ns,
                span.h2d_bytes, span.d2h_bytes,
            )


_global_profiler: Optional[Profiler] = None


def get_profiler() -> Profiler:
    global _global_profiler
    if _global_profiler is None:
        _global_profiler = Profiler()
    return _global_profiler


def stage(name: str) -> Span:
    return get_profiler().stage(name)


def request(name: str) -> Span:
    return get_profiler().request(name)


def entry(fn):
    """The entry point's own span, named after the function."""
    name = fn.__name__

    @functools.wraps(fn)
    def spanned(*args, **kwargs):
        with get_profiler().stage(name):
            return fn(*args, **kwargs)

    return spanned


def _span_record(span: Span, offset_us: float) -> dict:
    return {"name": span.name, "span": span.span_id, "parent": span.parent_id,
            "request": span.request_id, "tid": span.tid,
            "ts": 1e-3 * span.t0 + offset_us, "dur": 1e-3 * span.wall_ns,
            "h2d_bytes": span.h2d_bytes, "d2h_bytes": span.d2h_bytes}


def _annotate_trace(path: str, spans: List[Span]) -> Optional[float]:
    """Writes ``spans`` into the Chrome trace at ``path``: each program
    range (``user_annotation`` event) gets ``args`` request, span, parent
    and bytes, and the trace a ``programSpans`` list in its own clock.
    Events and spans of one name and thread pair in order; the offset
    between ``perf_counter_ns`` and the trace's clock is the median over
    the pairs of an event's start less its span's. Returns that offset in
    microseconds, None where no span pairs."""
    with open(path, encoding="utf-8") as f:
        trace = json.load(f)
    events = collections.defaultdict(list)
    for ev in trace.get("traceEvents", []):
        if ev.get("ph") == "X" and ev.get("cat") == "user_annotation":
            events[(ev.get("name"), ev.get("tid"))].append(ev)
    records = collections.defaultdict(list)
    for span in spans:
        records[(span.name, span.tid)].append(span)
    pairs = []
    for key, evs in events.items():
        recs = records.get(key, [])
        if recs and len(recs) == len(evs):
            evs.sort(key=lambda ev: float(ev["ts"]))
            recs.sort(key=lambda s: s.t0)
            pairs += zip(evs, recs)
    if not pairs:
        return None
    offset_us = statistics.median(
        float(ev["ts"]) - 1e-3 * span.t0 for ev, span in pairs)
    for ev, span in pairs:
        ev.setdefault("args", {}).update(
            request=span.request_id, span=span.span_id,
            parent=span.parent_id, h2d_bytes=span.h2d_bytes,
            d2h_bytes=span.d2h_bytes)
    trace["programSpans"] = [_span_record(s, offset_us) for s in spans]
    trace["programSpanOffsetUs"] = offset_us
    with open(path, "w", encoding="utf-8") as f:
        json.dump(trace, f)
    gaps = [abs(float(ev["ts"]) - 1e-3 * s.t0 - offset_us) for ev, s in pairs]
    logger.info("span log: %d spans on %d trace ranges, median gap %.1f us",
                len(spans), len(pairs), statistics.median(gaps))
    return offset_us


@contextlib.contextmanager
def trace_to(profile_dir: Optional[str]) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace into ``profile_dir/trace.json``,
    with the spans of the session written into it (:func:`_annotate_trace`)."""
    if not profile_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    was_enabled = _enabled
    enable()
    log = get_profiler().spans
    start = time.perf_counter_ns()
    try:
        with profile(activities=activities) as prof:
            yield
    finally:
        if not was_enabled:
            disable()
    spans = [s for s in log if s.t0 >= start]
    path = os.path.join(profile_dir, "trace.json")
    prof.export_chrome_trace(path)
    _annotate_trace(path, spans)
    logger.info("profile trace written to %s", path)
