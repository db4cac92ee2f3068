"""A batch of images per request: ``parallel.batch.encode_batch_containers``
then ``decode_batch_containers`` of its containers."""

from __future__ import annotations

from . import single

prepare = single.prepare
judge_unit = single.judge_unit


def request(state: dict, unit: dict) -> dict:
    from codec_tcc_tpu_torch.parallel import batch

    res = batch.encode_batch_containers(
        unit["images"], unit["payloads"], state["config"],
        bits_stored=state["bits_stored"], device=state["device"])
    decs = batch.decode_batch_containers(res.containers,
                                         restore_original=True,
                                         device=state["device"])
    return {"containers": res.containers,
            "payloads": [d.payload_bits for d in decs],
            "originals": [d.original for d in decs], "metrics": res.metrics}
