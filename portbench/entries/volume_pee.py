"""One PEE series per request: ``parallel.volume.encode_volume`` (strategy
``pee``: the capacity split over the slices, then the batch K3 by attempt
groups) and ``pack_volume``, then ``unpack_volume`` (the batch K4 by
threshold groups). The payload is read once, from the unpacked slices: a
PEE volume has no raster plan for ``extract_volume``. The slice
containers go back as ``containers``, so that a traced run counts their
work (``portbench.work``)."""

from __future__ import annotations

from ..reference import judge, raster, stgc
from .common import encode_config


def prepare(cfg: dict, device: str) -> dict:
    return {"config": encode_config(cfg), "device": device}


def request(state: dict, unit: dict) -> dict:
    from codec_tcc_tpu_torch.parallel import volume

    cfg, dev = state["config"], state["device"]
    res = volume.encode_volume(unit["volume"], unit["payloads"][0], cfg,
                               device=dev)
    blob = volume.pack_volume(unit["volume"], res, cfg, device=dev)
    payload, _, original = volume.unpack_volume(blob, device=dev)
    return {"stgv": blob, "containers": list(res.containers),
            "payloads": [payload], "originals": [original],
            "metrics": [res.metrics]}


def judge_unit(ref_mod, cfg: dict, unit: dict, out: dict, device) -> dict:
    """The STGV header, each slice's container against the reference's
    slice, the payload, the restored series and the volume's metrics."""
    vol, bits = unit["volume"], unit["payloads"][0]
    ref = ref_mod.encode_volume(vol, bits, cfg, device=device)
    got = stgc.parse_stgv(out["stgv"])
    head = {k: got[k] for k in ref["volume_header"]}
    res = {"header_fields": len(raster.header_mismatches(
        head, ref["volume_header"])), "stego_px": 0, "map_bits": 0}
    if got["depth"] != vol.shape[0]:
        res["stego_px"] = int(vol.size)
    for blob, want in zip(got["slices"], ref["slices"]):
        for k, v in judge._container(stgc.parse_stgc(blob), want).items():
            res[k] += v
    res["payload_bits"] = sum(judge.bit_errors(p, bits)
                              for p in out["payloads"])
    res["restored_px"] = judge.pixel_errors(out["originals"][0], vol)
    res["metric_gap"] = judge.metric_gap(out["metrics"][0], ref["metrics"])
    return res
