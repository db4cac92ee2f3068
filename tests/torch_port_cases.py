"""Realistic encode cases for parity between the JAX package and its torch
port — numpy only, so the machine with the GPU (which has no jax) can
rebuild every input bit for bit.

Each case is a seeded image (a smooth body-like phantom plus
``default_rng`` noise, clipped to BitsStored) and a payload. The JAX
package's containers for these inputs are not committed (the largest is
several MB); their hashes are, in ``tests/data/torch_port_parity.json``,
written by ``tests/make_torch_port_fixtures.py``. ``chip_smoke.py`` checks
every case on the GPU; ``tests/test_torch_pipeline.py`` regenerates the
small ones with both packages on the CPU.

Geometries follow the bundled 512x512 DICOMs and common radiograph sizes;
``odd500x501_u8`` has ``H*W % 8 != 0`` (raw XOR maps, no v2.1 packing).
All cases use STGC v2 and the default ``deflate`` codec.

The ``pee_*`` cases run strategy ``pee`` (no cut point: ``s = 0``). Between
them they take every branch of the PEE path: one pass and two, threshold
escalation after a shortfall, a saturated pass 0, u8 overflow pixels and
geometries with odd widths and ``H*W % 8 != 0``.

The ``blk_*`` cases run strategy ``block_adaptive`` (block 8, or 12 on
``blk_odd640x480_u16_b12``): uniform tilings, edge tiles on one axis and on
both, raw maps (``H*W % 8 != 0``) and 2048x2048 at capacity. The ``host_*``
cases take the host embed route: ``device_policy="host"``, and ``"auto"``
with ``compute_metrics=False`` at 2048x2048.
"""

from __future__ import annotations

import hashlib
import json
import os
from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
PARITY_JSON = os.path.join(DATA, "torch_port_parity.json")

TEXT_PAYLOAD = "Mensagem de teste para esteganografia!"   # 304 bits


@dataclass(frozen=True)
class Case:
    name: str
    height: int
    width: int
    dtype: str           # "uint8" / "uint16"
    bits_stored: int
    payload: str         # "text", "capacity" or "bits:<n>"
    strategy: str
    seed: int
    # EncodeConfig fields other than the strategy, as (name, value) pairs
    overrides: Tuple[Tuple[str, object], ...] = ()

    def config(self, config_cls):
        """``config_cls`` (either package's ``EncodeConfig``) for the case."""
        return config_cls(strategy=self.strategy, **dict(self.overrides))


CASES = (
    Case("mr512_u16", 512, 512, "uint16", 12, "text", "hybrid", 11),
    Case("mr512_u16_full", 512, 512, "uint16", 12, "capacity", "hybrid", 12),
    Case("ot512_u8", 512, 512, "uint8", 8, "text", "hybrid", 13),
    Case("cr2048_u16_full", 2048, 2048, "uint16", 12, "capacity", "hybrid", 14),
    Case("odd640x480_u16", 480, 640, "uint16", 12, "bits:4096", "multi_plane", 15),
    Case("odd500x501_u8", 500, 501, "uint8", 8, "bits:4096", "hybrid", 16),
    Case("pee_mr512_u16_text", 512, 512, "uint16", 12, "text", "pee", 21),
    Case("pee_mr512_u16_100k", 512, 512, "uint16", 12, "bits:100000", "pee",
         22),
    Case("pee_ot512_u8_100k", 512, 512, "uint8", 8, "bits:100000", "pee", 23),
    Case("pee_odd640x480_u16_4k", 480, 640, "uint16", 12, "bits:4096", "pee",
         24),
    Case("pee_odd500x501_u8_50k", 500, 501, "uint8", 8, "bits:50000", "pee",
         25),
    Case("pee_cr2048_u16_3m", 2048, 2048, "uint16", 12, "bits:3000000", "pee",
         26),
    Case("blk_mr512_u16", 512, 512, "uint16", 12, "text", "block_adaptive",
         31),
    Case("blk_mr512_u16_full", 512, 512, "uint16", 12, "capacity",
         "block_adaptive", 32),
    Case("blk_odd500x501_u8", 500, 501, "uint8", 8, "bits:4096",
         "block_adaptive", 33),
    Case("blk_odd640x480_u16_b12", 480, 640, "uint16", 12, "bits:4096",
         "block_adaptive", 34, (("block_size", 12),)),
    Case("blk_cr2048_u16_full", 2048, 2048, "uint16", 12, "capacity",
         "block_adaptive", 35),
    Case("host_mr512_u16", 512, 512, "uint16", 12, "text", "hybrid", 36,
         (("device_policy", "host"),)),
    Case("host_odd640x480_u16", 480, 640, "uint16", 12, "bits:4096",
         "multi_plane", 37, (("device_policy", "host"),)),
    Case("host_cr2048_u16_full", 2048, 2048, "uint16", 12, "capacity",
         "hybrid", 38, (("compute_metrics", False),)),
)
BY_NAME = {c.name: c for c in CASES}


def image(case: Case) -> np.ndarray:
    """Smooth phantom (an elliptic body with two inner structures and a
    gentle gradient) plus seeded Gaussian noise, clipped to BitsStored."""
    h, w = case.height, case.width
    maxval = (1 << case.bits_stored) - 1
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    y = (y - h / 2) / (h / 2)
    x = (x - w / 2) / (w / 2)
    body = ((x / 0.85) ** 2 + (y / 0.75) ** 2 < 1.0) * 0.45
    organ = ((x + 0.3) ** 2 / 0.04 + y ** 2 / 0.09 < 1.0) * 0.25
    bone = ((x - 0.35) ** 2 + (y + 0.2) ** 2 < 0.01) * 0.35
    smooth = 0.05 + body + organ + bone + 0.1 * (x + 1.0)
    rng = np.random.default_rng(case.seed)
    noisy = smooth * maxval + rng.normal(0.0, 0.02 * maxval, (h, w))
    return np.clip(np.rint(noisy), 0, maxval).astype(case.dtype)


def payload_bits(case: Case, capacity_bits: int) -> np.ndarray:
    """The case's payload as uint8 0/1 bits. ``capacity_bits`` — the
    caller's ``usable_capacity_bits(s, H*W, 42)`` for the image's cut
    point — sizes the ``capacity`` cases and is ignored otherwise."""
    if case.payload == "text":
        return np.unpackbits(np.frombuffer(TEXT_PAYLOAD.encode(), np.uint8))
    if case.payload == "capacity":
        nbits = capacity_bits
    else:
        nbits = int(case.payload.split(":", 1)[1])
    rng = np.random.default_rng(case.seed + 1000)
    return rng.integers(0, 2, nbits, dtype=np.uint8)


def pee_attempt_groups(t_start, t_final) -> int:
    """Equal-T groups the PEE encoders' escalation loop embeds, each with
    one K3 launch per pass: an image that starts at ``t_start`` is in round
    ``k`` at ``T = t_start + k`` until it fits at ``t_final``, and the
    images of one round that share a T form one group."""
    return len({(k, int(s) + k) for s, f in zip(t_start, t_final)
                for k in range(int(f) - int(s) + 1)})


def sha256(data) -> str:
    if isinstance(data, np.ndarray):
        data = np.ascontiguousarray(data).tobytes()
    return hashlib.sha256(data).hexdigest()


def load_parity() -> Dict[str, dict]:
    with open(PARITY_JSON, encoding="utf-8") as f:
        return json.load(f)["cases"]
