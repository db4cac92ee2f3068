"""One image per request: ``pipeline.encode_array`` then
``pipeline.decode_container(restore_original=True)``."""

from __future__ import annotations

from ..reference import judge
from .common import encode_config


def prepare(cfg: dict, device: str) -> dict:
    return {"config": encode_config(cfg), "bits_stored": cfg["bits_stored"],
            "device": device}


def request(state: dict, unit: dict) -> dict:
    from codec_tcc_tpu_torch import pipeline

    res = pipeline.encode_array(unit["images"][0], unit["payloads"][0],
                                state["config"],
                                bits_stored=state["bits_stored"],
                                device=state["device"])
    dec = pipeline.decode_container(res.container, restore_original=True,
                                    device=state["device"])
    return {"containers": [res.container], "payloads": [dec.payload_bits],
            "originals": [dec.original], "metrics": [res.metrics]}


def judge_unit(ref_mod, cfg: dict, unit: dict, out: dict, device) -> dict:
    return judge.merge([
        judge.image(ref_mod, cfg, img, bits, c, p, o, m, device)
        for img, bits, c, p, o, m in zip(
            unit["images"], unit["payloads"], out["containers"],
            out["payloads"], out["originals"], out["metrics"])])
