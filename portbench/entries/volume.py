"""One series per request: ``parallel.volume.encode_volume`` and
``pack_volume``, then ``unpack_volume`` and ``extract_volume`` (the
payload read twice: from the unpacked slices on the host and by the
batch K2 from the stego)."""

from __future__ import annotations

from ..reference import judge
from .common import encode_config


def prepare(cfg: dict, device: str) -> dict:
    return {"config": encode_config(cfg), "device": device}


def request(state: dict, unit: dict) -> dict:
    from codec_tcc_tpu_torch.parallel import volume

    cfg, dev = state["config"], state["device"]
    res = volume.encode_volume(unit["volume"], unit["payloads"][0], cfg,
                               device=dev)
    blob = volume.pack_volume(unit["volume"], res, cfg, device=dev)
    payload, stego, original = volume.unpack_volume(blob, device=dev)
    extracted = volume.extract_volume(stego, res.plan, device=dev)
    return {"stgv": blob, "payloads": [payload, extracted],
            "originals": [original], "metrics": [res.metrics]}


def judge_unit(ref_mod, cfg: dict, unit: dict, out: dict, device) -> dict:
    return judge.volume(cfg, unit["volume"], unit["payloads"][0], out["stgv"],
                        out["payloads"], out["originals"][0],
                        out["metrics"][0])
