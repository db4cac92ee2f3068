"""The port's PEE volume route (``parallel/volume.py::_encode_volume_pee``,
``parallel/batch_pee.py``) against the benchmark's plain reference
(``portbench/reference/pee_volume.py``, written from the split's
description, sharing no code with the port), on the CPU: every series is
judged as the benchmark judges it (every count 0); the route's stages
carry the archive names, none that an archive reader sums opens inside
another; its counters follow the attempt groups, the escalations, the
decode's threshold groups, the splits and the probes.

    python -m pytest tests/test_torch_pee_volume_route.py -q
"""

import numpy as np
import pytest
import torch

from codec_tcc_tpu_torch import EncodeConfig, profiling
from codec_tcc_tpu_torch.errors import CapacityError
from codec_tcc_tpu_torch.io.container import parse, parse_pee_ext
from codec_tcc_tpu_torch.parallel import batch_pee
from codec_tcc_tpu_torch.parallel import volume as pv

pytest.importorskip("portbench")
from portbench.entries import volume_pee  # noqa: E402
from portbench.reference import pee_volume  # noqa: E402
from portbench.traffic import generator  # noqa: E402

import torch_port_cases as cases  # noqa: E402

torch.set_num_threads(1)

CFG = {"strategy": "pee", "codec": "deflate", "seed": 42, "pee_threshold": 2,
       "bits_stored": 12, "compute_metrics": True}
# the archive readers' sums (portbench/metrics/codec_ms.archive.py,
# plan_ms.archive.py): none of a set may open inside another of it
SUMMED = ({"batch_pack", "volume_pack", "batch_codec_decode"},
          {"batch_plan", "volume_cut_point", "volume_plan"})
STAGES = {"encode_volume", "volume_upload", "volume_plan", "batch_plan",
          "batch_embed", "batch_pack", "volume_metrics", "pack_volume",
          "unpack_volume", "decode_batch_containers", "batch_codec_decode",
          "batch_extract", "volume_unstack"}
# (depth, height, width, bits a pixel): one pass; both passes with T
# rising; odd geometries; slices left without a chunk
SERIES = [(4, 32, 32, 0.05), (4, 64, 64, 0.5), (3, 37, 53, 0.4),
          (64, 32, 32, 0.1)]


def _series(d, h, w, load, seed=2**31 + 3):
    vol = generator.volume(d, h, w, "uint16", 12, seed, 0)
    return vol, generator.payload(int(load * d * h * w), seed, 0, 0)


def _request(vol, bits):
    state = volume_pee.prepare(CFG, "cpu")
    return volume_pee.request(state, {"volume": vol, "payloads": [bits]})


@pytest.mark.parametrize("d,h,w,load", SERIES,
                         ids=[f"{d}x{h}x{w}-{load}" for d, h, w, load in SERIES])
def test_pee_volume_agrees_with_the_reference(d, h, w, load):
    vol, bits = _series(d, h, w, load)
    out = _request(vol, bits)
    unit = {"volume": vol, "payloads": [bits]}
    got = volume_pee.judge_unit(pee_volume, CFG, unit, out, "cpu")
    assert {k: v for k, v in got.items() if k != "metric_gap"} == {
        "header_fields": 0, "stego_px": 0, "map_bits": 0,
        "payload_bits": 0, "restored_px": 0}
    assert got["metric_gap"] < 1e-5
    ref = pee_volume.encode_volume(vol, bits, CFG)
    assert int(ref["slice_bits"].sum()) == bits.size
    if d == 64:
        assert ref["slice_bits"][-1] == 0
    for c in out["containers"]:
        meta = parse(c).meta
        assert meta.nbits == meta.bits_stored == 16


def test_reference_split_is_contiguous_and_least():
    vol, bits = _series(4, 64, 64, 0.5)
    caps = pee_volume.slice_capacities(vol, 65535)
    t, sizes = pee_volume.split(caps, bits.size, 2, 64)
    held = np.maximum(caps - 64, 0)
    assert int(sizes.sum()) == bits.size
    assert held[:, t - 2].sum() < bits.size <= held[:, t - 1].sum()
    full = np.flatnonzero(sizes < held[:, t - 1])
    # every slice before the first short one is full, every one after empty
    assert (sizes[full[1:]] == 0).all() if full.size else True
    assert pee_volume.split(caps, int(caps[:, -1].sum()) + 1, 2, 64) is None
    with pytest.raises(ValueError, match="probe"):
        pee_volume.encode_volume(vol, np.zeros(int(caps[:, -1].sum()) + 1,
                                               np.uint8), CFG)


def _traced_request(vol, bits):
    prof = profiling.get_profiler()
    prof.reset()
    profiling.enable()
    try:
        out = _request(vol, bits)
    finally:
        profiling.disable()
    return out, prof


def test_stages_are_the_archive_names_and_do_not_nest():
    vol, bits = _series(4, 64, 64, 0.5)
    out, prof = _traced_request(vol, bits)
    try:
        assert set(prof.wall) == STAGES
        spans = {s.span_id: s for s in prof.spans}
        for summed in SUMMED:
            for s in prof.spans:
                if s.name not in summed:
                    continue
                p = spans.get(s.parent_id)
                while p is not None:
                    assert p.name not in summed, (s.name, p.name)
                    p = spans.get(p.parent_id)
        # the batch encode runs outside the split's stage
        parents = {spans[s.parent_id].name for s in prof.spans
                   if s.name in ("batch_plan", "batch_embed", "batch_pack")}
        assert parents == {"encode_volume"}
    finally:
        prof.reset()


def test_counters_follow_the_attempt_groups(monkeypatch):
    """``pee.batch_groups`` is the K3 wrapper's calls over 2, the groups
    that ``torch_port_cases.pee_attempt_group_lists`` replays;
    ``pee.batch_escalated`` the entries of those groups that fell short;
    ``pee.decode_groups`` the K4 calls over 2; one batch encode and no
    probe; and only the entries that fit download their stego."""
    from codec_tcc_tpu_torch.ops import pee_kernels as pk

    calls = {"pee_embed": 0, "pee_extract": 0}
    for name in calls:
        def counted(*args, _name=name, _fn=getattr(pk, name)):
            calls[_name] += 1
            return _fn(*args)
        monkeypatch.setattr(pk, name, counted)
    stego_rows = []

    def download(t):
        if t.dim() == 3 and t.dtype == torch.uint16:
            stego_rows.append(t.shape[0])
        return real_download(t)

    real_download = batch_pee.download
    monkeypatch.setattr(batch_pee, "download", download)
    vol, bits = _series(8, 64, 64, 0.5)
    prof = profiling.get_profiler()
    prof.reset()
    try:
        out = _request(vol, bits)
        c = profiling.counters()
    finally:
        prof.reset()
    res_bits = [parse(x).meta.payload_bits for x in out["containers"]]
    t_final = [parse_pee_ext(parse(x).meta.ext)[0] for x in out["containers"]]
    t_start = batch_pee._start_thresholds(torch.from_numpy(vol),
                                          np.asarray(res_bits), 65535, 2)
    groups = cases.pee_attempt_group_lists(t_start, t_final)
    assert c["pee.batch_groups"] == calls["pee_embed"] // 2 == len(groups)
    # an entry that falls short re-queues, a slice pending twice included
    assert c["pee.batch_escalated"] == sum(
        1 for t, idxs in groups for i in idxs if t < t_final[i]) > 0
    assert c["pee.decode_groups"] == calls["pee_extract"] // 2 == len(
        set(t_final))
    # only the entries that hold their chunk bring their stego back, then
    # the decode its 8 restored slices
    assert sum(stego_rows) == sum(
        1 for t, idxs in groups for i in idxs if t == t_final[i]) + 8
    assert c["volume.pee_encodes"] == 1
    assert "volume.pee_probes" not in c
    assert c["pee.map_host"] == 8


def test_counters_count_the_resplit_and_the_probe(monkeypatch):
    """Batch encodes that run out of capacity at both discounts send the
    split to the exact probe: three encodes, one probe at least, and the
    series still decodes to its payload."""
    real = batch_pee.encode_pee_batch
    failures = {"left": 2}

    def short(*a, **k):
        if failures["left"]:
            failures["left"] -= 1
            raise CapacityError("injected")
        return real(*a, **k)

    monkeypatch.setattr(batch_pee, "encode_pee_batch", short)
    vol, bits = _series(4, 48, 48, 0.3)
    prof = profiling.get_profiler()
    prof.reset()
    try:
        res = pv.encode_volume(vol, bits, EncodeConfig(strategy="pee"),
                               device="cpu")
        c = profiling.counters()
    finally:
        prof.reset()
    assert c["volume.pee_encodes"] == 3
    assert c["volume.pee_probes"] >= 1
    blob = pv.pack_volume(vol, res, EncodeConfig(strategy="pee"),
                          device="cpu")
    payload, _, original = pv.unpack_volume(blob, device="cpu")
    np.testing.assert_array_equal(payload, bits)
    np.testing.assert_array_equal(original, vol)
