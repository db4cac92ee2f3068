"""The port's one instrument (``codec_tcc_tpu_torch.profiling``): spans
with a request, a parent and self time; the counter registry; the span
log and its ring; the span log in a ``trace_to`` trace, on the trace's
clock; the copy helpers as the only way to the device and back; the
benchmark's readers of the spans and counters. All on the CPU."""

from __future__ import annotations

import ast
import json
import pathlib
import statistics
import time

import numpy as np
import pytest
import torch

import torch_port_cases as cases
from codec_tcc_tpu_torch import pipeline, profiling, serve
from codec_tcc_tpu_torch.device import download, to_device, upload

PACKAGE = pathlib.Path(profiling.__file__).resolve().parent


@pytest.fixture
def traced():
    """Tracing on for the test, off and the global profiler zeroed after."""
    prof = profiling.get_profiler()
    prof.reset()
    profiling.enable()
    try:
        yield prof
    finally:
        profiling.disable()
        prof.reset()


def _image(h=64, w=64, seed=3):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 4096, (h, w)).astype(np.uint16)


def test_decode_inside_a_request_shares_its_id_and_parents(traced):
    res = pipeline.encode_array(_image(), "spans", bits_stored=12,
                                device="cpu")
    traced.reset()
    with profiling.request("client") as req:
        pipeline.decode_container(res.container, device="cpu")
        pipeline.decode_container(res.container, device="cpu")
    spans = list(traced.spans)
    assert {s.request_id for s in spans} == {req.request_id}
    decodes = [s for s in spans if s.name == "decode_container"]
    assert len(decodes) == 2
    assert all(d.parent_id == req.span_id for d in decodes)
    for d in decodes:
        stages = [s for s in spans if s.parent_id == d.span_id]
        assert {s.name for s in stages} == {"transport_decode", "extract",
                                            "restore"}
        assert all(d.t0 <= s.t0 <= s.t1 <= d.t1 for s in stages)
    assert req.parent_id == 0
    # without a request, each entry call starts one of its own
    traced.reset()
    pipeline.decode_container(res.container, device="cpu")
    pipeline.decode_container(res.container, device="cpu")
    roots = [s for s in traced.spans if s.parent_id == 0]
    assert [s.name for s in roots] == ["decode_container"] * 2
    assert roots[0].request_id != roots[1].request_id


def test_self_time_is_wall_less_child_spans():
    prof = profiling.Profiler()
    with prof.stage("outer") as outer:
        time.sleep(0.004)
        with prof.stage("inner") as a:
            time.sleep(0.006)
            with prof.stage("leaf") as leaf:
                time.sleep(0.002)
        with prof.stage("inner") as b:
            time.sleep(0.003)
        time.sleep(0.002)
    assert outer.self_ns == outer.wall_ns - a.wall_ns - b.wall_ns
    assert a.self_ns == a.wall_ns - leaf.wall_ns
    assert leaf.self_ns == leaf.wall_ns
    assert b.self_ns == b.wall_ns
    assert outer.self_ns >= 6_000_000      # the 4 + 2 ms outside children
    assert prof.self_wall["outer"] == pytest.approx(1e-9 * outer.self_ns)
    assert prof.self_wall["inner"] == pytest.approx(
        1e-9 * (a.self_ns + b.self_ns))
    assert prof.wall["inner"] == pytest.approx(1e-9 * (a.wall_ns + b.wall_ns))
    assert prof.calls == {"outer": 1, "inner": 2, "leaf": 1}
    assert leaf.parent_id == a.span_id and a.parent_id == outer.span_id
    assert b.parent_id == outer.span_id
    assert {s.request_id for s in (outer, a, b, leaf)} == {outer.request_id}
    report = prof.report()
    assert report["outer"]["self_s"] == pytest.approx(1e-9 * outer.self_ns)
    assert report["inner"]["calls"] == 2


def test_tracing_off_keeps_sums_and_counters_but_no_span_log():
    assert not profiling.tracing()
    prof = profiling.get_profiler()
    prof.reset()
    res = pipeline.encode_array(_image(), "off", bits_stored=12, device="cpu")
    pipeline.decode_container(res.container, device="cpu")
    profiling.count("launch.test_kernel", 3)
    assert len(prof.spans) == 0
    assert {"encode_array", "image_upload", "decompose", "block_scan",
            "embed", "transport_codec", "decode_container",
            "transport_decode", "extract", "restore"} <= set(prof.wall)
    assert prof.calls["encode_array"] == 1
    assert profiling.counters()["launch.test_kernel"] == 3
    assert profiling.launches(["test_kernel", "none"]) == {
        "test_kernel": 3, "none": 0}
    prof.reset()
    assert prof.wall == {} and prof.self_wall == {} and prof.calls == {}
    assert profiling.counters() == {}
    assert len(prof.spans) == 0


def test_ring_drops_the_oldest_and_counts_them():
    prof = profiling.Profiler(ring_size=4)
    profiling.get_profiler().reset()
    profiling.enable()
    try:
        for i in range(7):
            with prof.stage(f"s{i}"):
                pass
    finally:
        profiling.disable()
    assert [s.name for s in prof.spans] == ["s3", "s4", "s5", "s6"]
    assert profiling.counters()["spans_dropped"] == 3
    assert prof.calls == {f"s{i}": 1 for i in range(7)}
    profiling.get_profiler().reset()


def test_trace_puts_every_span_on_its_range(tmp_path):
    profiling.get_profiler().reset()
    img = _image()
    pipeline.encode_array(img, "warm", bits_stored=12, device="cpu")
    with profiling.trace_to(str(tmp_path)):
        pipeline.encode_array(img, "traced", bits_stored=12, device="cpu")
    assert not profiling.tracing()
    with open(tmp_path / "trace.json", encoding="utf-8") as f:
        trace = json.load(f)
    records = trace["programSpans"]
    names = {r["name"] for r in records}
    assert {"encode_array", "image_upload", "decompose", "block_scan",
            "embed", "transport_codec"} <= names
    ranges = {ev["args"]["span"]: ev for ev in trace["traceEvents"]
              if ev.get("cat") == "user_annotation"
              and "span" in ev.get("args", {})}
    gaps = []
    for r in records:
        ev = ranges[r["span"]]
        assert ev["name"] == r["name"]
        assert ev["args"]["request"] == r["request"]
        assert ev["args"]["parent"] == r["parent"]
        assert ev["args"]["h2d_bytes"] == r["h2d_bytes"] == 0
        gaps.append(abs(float(ev["ts"]) - r["ts"]))
    assert statistics.median(gaps) <= 50.0
    assert max(gaps) <= 1000.0
    root = [r for r in records if r["name"] == "encode_array"]
    assert len(root) == 1 and root[0]["parent"] == 0
    assert {r["request"] for r in records} == {root[0]["request"]}
    profiling.get_profiler().reset()


def test_a_cpu_tensor_counts_no_copy():
    prof = profiling.get_profiler()
    prof.reset()
    cpu = torch.device("cpu")
    t = upload(np.arange(10, dtype=np.int32), cpu)
    to_device(t, cpu)
    to_device(np.zeros(3), cpu)
    np.testing.assert_array_equal(download(t), np.arange(10))
    assert "h2d_bytes" not in profiling.counters()
    assert "d2h_bytes" not in profiling.counters()


def test_copies_count_into_the_innermost_span(monkeypatch):
    """The bytes go to the counter and to the span open when they were
    copied, not to its parent."""
    prof = profiling.Profiler()
    profiling.get_profiler().reset()
    with prof.stage("outer") as outer:
        profiling.copied("h2d_bytes", 100)
        with prof.stage("inner") as inner:
            profiling.copied("h2d_bytes", 7)
            profiling.copied("d2h_bytes", 5)
        profiling.copied("d2h_bytes", 11)
    assert (outer.h2d_bytes, outer.d2h_bytes) == (100, 11)
    assert (inner.h2d_bytes, inner.d2h_bytes) == (7, 5)
    assert profiling.counters() == {"h2d_bytes": 107, "d2h_bytes": 16}
    assert prof.report()["inner"]["d2h_bytes"] == 5
    profiling.get_profiler().reset()


def _calls_named(tree, names):
    return [node.lineno for node in ast.walk(tree)
            if isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr in names]


def test_no_copy_outside_the_device_helpers():
    """``.cpu()`` and ``.cuda()`` appear in ``device.py`` alone: every other
    copy goes through its counted helpers."""
    found = {}
    for path in sorted(PACKAGE.rglob("*.py")):
        if path.name == "device.py" and path.parent == PACKAGE:
            continue
        lines = _calls_named(ast.parse(path.read_text()), ("cpu", "cuda"))
        if lines:
            found[str(path.relative_to(PACKAGE))] = lines
    assert found == {}
    device_src = (PACKAGE / "device.py").read_text()
    assert _calls_named(ast.parse(device_src), ("cpu",))


def test_serve_reply_takes_its_wall_from_the_request_span():
    prof = profiling.get_profiler()
    prof.reset()
    state = {"t0": time.monotonic(), "served": 0, "op_counts": {},
             "device": "cpu"}
    out, stop = serve._handle_line(b'{"op": "ping"}', state)
    assert out["ok"] and not stop
    assert out["wall_ms"] == round(1e3 * prof.wall["serve.ping"], 2)
    assert prof.calls["serve.ping"] == 1
    prof.reset()


@pytest.mark.parametrize("cell,names", [
    ("mr512_hybrid.single", ("copy_mb.single", "shell_ms.single")),
    ("cr2048_pee.single", ("copy_mb.single", "shell_ms.single")),
    ("mr512_hybrid.batch32", ("copy_mb.archive", "shell_ms.archive")),
    ("mr512_hybrid.volume64", ("copy_mb.archive", "shell_ms.archive")),
])
def test_benchmark_readers_of_spans_and_counters(cell, names):
    pytest.importorskip("portbench")
    from portbench import harness, stats
    from portbench.tests.small import SMALL

    result, _ = harness.run_cell(cell, 2**31 + 11, 0.3, True, device="cpu",
                                 t0=time.perf_counter(),
                                 overrides=SMALL[cell])
    ctx = stats.Context(setup_s=0.0, window_s=result["window_s"],
                        durations=[0.0] * result["requests"], pixels=[],
                        container_bytes=[], stages={})
    copy_name, shell_name = names
    assert result["metrics"][copy_name]["value"] == 0.0
    assert harness.read_metric(copy_name, ctx) == 0.0
    shell = result["metrics"][shell_name]["value"]
    assert isinstance(shell, float) and 0.0 < shell
    assert harness.read_metric(shell_name, ctx) == pytest.approx(shell)
    profiling.get_profiler().reset()


def test_parity_case_encodes_unchanged_under_tracing(traced):
    """Spans compute nothing: an encode with tracing on gives the bytes of
    one with tracing off."""
    case = cases.BY_NAME["ot512_u8"]
    img = cases.image(case)
    on = pipeline.encode_array(img, "same", device="cpu").container
    profiling.disable()
    off = pipeline.encode_array(img, "same", device="cpu").container
    assert on == off
