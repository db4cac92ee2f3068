"""One large image per request over the bands of a ``tile`` mesh:
``parallel.tile_pee.encode_array_tiled_pee`` then
``decode_container_tiled_pee(restore_original=True)``. The mesh, built
once, holds the configuration's ``bands`` bands, all on the run's device.
The tiled container must equal the whole-image one, so a unit is judged
as the single-image entry judges it."""

from __future__ import annotations

from . import single
from .common import encode_config

judge_unit = single.judge_unit


def prepare(cfg: dict, device: str) -> dict:
    from codec_tcc_tpu_torch.parallel import make_mesh

    return {"config": encode_config(cfg), "bits_stored": cfg["bits_stored"],
            "mesh": make_mesh(devices=[device] * int(cfg["bands"]),
                              axes=("tile",))}


def request(state: dict, unit: dict) -> dict:
    from codec_tcc_tpu_torch.parallel import tile_pee

    res = tile_pee.encode_array_tiled_pee(
        unit["images"][0], unit["payloads"][0], state["config"],
        state["mesh"], bits_stored=state["bits_stored"])
    dec = tile_pee.decode_container_tiled_pee(res.container, state["mesh"],
                                              restore_original=True)
    return {"containers": [res.container], "payloads": [dec.payload_bits],
            "originals": [dec.original], "metrics": [res.metrics]}
