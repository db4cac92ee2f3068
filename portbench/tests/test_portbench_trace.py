"""The trace reader on a hand-made Chrome trace: busy time as the union
of device operations, device time by the host range that launched it,
and idle gaps named by the innermost range open on the host."""

import json

import pytest

from portbench import trace


def X(cat, name, ts, dur, tid=1, corr=None):
    ev = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
          "pid": 1, "tid": tid}
    if corr is not None:
        ev["args"] = {"correlation": corr}
    return ev


@pytest.fixture
def summary(tmp_path):
    events = [
        X("user_annotation", "portbench.request", 0, 100),
        X("user_annotation", "embed", 10, 20),
        X("user_annotation", "transport_codec", 40, 50),
        X("user_annotation", "portbench.request", 100, 100),
        X("user_annotation", "extract", 110, 10),
        X("user_annotation", "other thread", 0, 300, tid=9),
        X("cuda_runtime", "cudaLaunchKernel", 12, 1, corr=1),
        X("cuda_runtime", "cudaLaunchKernel", 14, 1, corr=2),
        X("cuda_runtime", "cudaMemcpyAsync", 25, 1, corr=3),
        X("cuda_driver", "cuLaunchKernel", 112, 1, corr=4),
        X("kernel", "void k1<int>(int*)", 20, 5, tid=7, corr=1),
        X("gpu_memset", "Memset (Device)", 22, 6, tid=7, corr=2),
        X("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 30, 4, tid=7,
          corr=3),
        X("kernel", "void ns::k4(short*)", 150, 10, tid=7, corr=4),
        X("gpu_user_annotation", "embed", 20, 14, tid=7),
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return trace.analyse(str(path))


def test_busy_is_the_union(summary):
    # [20, 28) + [30, 34) + [150, 160) of a [0, 200) window
    assert summary["window_s"] == pytest.approx(200e-6)
    assert summary["busy_s"] == pytest.approx(22e-6)


def test_device_time_by_launching_range(summary):
    r = summary["range_device_s"]
    assert r["embed"] == pytest.approx(11e-6)        # kernel + memset
    assert r["extract"] == pytest.approx(10e-6)      # launched at 112
    assert "transport_codec" not in r                # copies are not counted
    assert summary["unlinked_ops"] == 0


def test_ops_and_gaps_ranked(summary):
    ops = dict(summary["device_ops"])
    assert ops["k4"] == pytest.approx(10e-6) and "k1" in ops
    gaps = dict(summary["idle_gaps"])
    # idle: [0,20) request 10 + embed 10; [28,30) embed; [34,150):
    # request 6 + transport_codec 50 + request 10, then request 10 +
    # extract 10 + request 30; [160,200) request 40
    assert gaps["embed"] == pytest.approx(12e-6)
    assert gaps["transport_codec"] == pytest.approx(50e-6)
    assert gaps["extract"] == pytest.approx(10e-6)
    assert gaps["portbench.request"] == pytest.approx(106e-6)
