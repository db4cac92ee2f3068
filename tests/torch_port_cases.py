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

The ``vol_*`` cases (:data:`VOLUME_CASES`) are STGV volumes through
``parallel.volume``: the 64x512x512 uint16 volume of BASELINE.json
config[3] under ``hybrid`` and ``multi_plane`` with the 304-bit text and
with half the volume's LSB capacity (``capacity_report``'s ``lsb_bits``),
PEE on 8x512x512 uint16 with 1 Mbit, ``block_adaptive`` on 8x512x512
uint16, and a 5x500x501 uint8 volume (``H*W % 8 != 0``: raw maps). The
fixture also holds ``capacity_report`` on ``mr512_u16`` and on the
64-slice volume, and ``analyze_pair`` on the 512x512 encode of
``mr512_u16_full`` (:data:`ANALYZE_CASES`).

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


@dataclass(frozen=True)
class VolumeCase:
    name: str
    depth: int
    height: int
    width: int
    dtype: str           # "uint8" / "uint16"
    bits_stored: int
    payload: str         # "text", "half" (half the LSB capacity) or "bits:<n>"
    strategy: str
    seed: int
    codec: str = "deflate"

    def config(self, config_cls):
        return config_cls(strategy=self.strategy, codec=self.codec)


VOLUME_CASES = (
    VolumeCase("vol64_u16_hybrid_text", 64, 512, 512, "uint16", 12, "text",
               "hybrid", 41),
    VolumeCase("vol64_u16_hybrid_half", 64, 512, 512, "uint16", 12, "half",
               "hybrid", 41),
    VolumeCase("vol64_u16_multi_text", 64, 512, 512, "uint16", 12, "text",
               "multi_plane", 41),
    VolumeCase("vol64_u16_multi_half", 64, 512, 512, "uint16", 12, "half",
               "multi_plane", 41),
    VolumeCase("vol8_u16_pee_1m", 8, 512, 512, "uint16", 12, "bits:1000000",
               "pee", 42),
    VolumeCase("vol8_u16_block_half", 8, 512, 512, "uint16", 12, "half",
               "block_adaptive", 43),
    VolumeCase("vol5_odd500x501_u8_half", 5, 500, 501, "uint8", 8, "half",
               "hybrid", 44),
)
VOLUMES_BY_NAME = {c.name: c for c in VOLUME_CASES}

# capacity_report inputs: a parity case's image (2-D) or a volume case's
# volume (3-D), with the BitsStored the 2-D report is given
CAPACITY_CASES = (("cap_mr512_u16", "mr512_u16"),
                  ("cap_vol64_u16", "vol64_u16_hybrid_text"))
# analyze_pair inputs: a parity case's image and its stego from
# encode_array with the case's payload; "data" takes the ranges from the
# data maxima (equal here: the fused moments), "12_16" passes the ranges of
# a BitsStored 12 original and a BitsStored 16 stego (the range-normalised
# float64 host branch)
ANALYZE_CASES = (("ana_mr512_u16_full_data", "mr512_u16_full", "data"),
                 ("ana_mr512_u16_full_12_16", "mr512_u16_full", "12_16"))
ANALYZE_RANGES = {"data": {},
                  "12_16": {"range_a": 4095.0, "range_b": 65535.0}}
# volumes whose quality report (``VolumeResult.metrics``) the fixture holds
# under ``metrics_<name>``: the text payloads, which leave the volume's
# maximum unchanged, so the report is the equal-range branch of float32
# moments (the normalised branch cancels in float32 and is not compared)
VOLUME_METRICS_CASES = ("vol64_u16_hybrid_text", "vol64_u16_multi_text")
# the CLI ``analyze --windowed-ssim --report`` of the pair that
# :func:`cli_analyze_pair` writes
CLI_ANALYZE_CASE = "cli_analyze_mr512_u16_xor1"


def cli_analyze_pair(save_image, directory: str) -> Tuple[str, str]:
    """Write ``o.dcm`` (the ``mr512_u16`` image) and ``s.dcm`` (the same
    with every low bit flipped) as 12-bit DICOMs into ``directory`` with
    the given package's ``io.dicom.save_image``; return their paths."""
    img = image(BY_NAME["mr512_u16"])
    paths = (os.path.join(directory, "o.dcm"), os.path.join(directory, "s.dcm"))
    save_image(img, paths[0], bits_stored=12)
    save_image(img ^ np.uint16(1), paths[1], bits_stored=12)
    return paths


def volume(case: VolumeCase) -> np.ndarray:
    """``(depth, H, W)`` volume: per slice the phantom of :func:`image`
    with its own noise seed and the inner structures moving with the slice
    index, clipped to BitsStored."""
    d, h, w = case.depth, case.height, case.width
    maxval = (1 << case.bits_stored) - 1
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    y = (y - h / 2) / (h / 2)
    x = (x - w / 2) / (w / 2)
    body = ((x / 0.85) ** 2 + (y / 0.75) ** 2 < 1.0) * 0.45
    ramp = 0.05 + body + 0.1 * (x + 1.0)
    out = np.empty((d, h, w), dtype=case.dtype)
    for k in range(d):
        z = k / max(d - 1, 1) - 0.5
        organ = ((x + 0.3) ** 2 / 0.04 + (y - 0.3 * z) ** 2 / 0.09 < 1.0) * 0.25
        bone = ((x - 0.35) ** 2 + (y + 0.2 + 0.2 * z) ** 2 < 0.01) * 0.35
        rng = np.random.default_rng(case.seed * 1000 + k)
        noisy = (ramp + organ + bone) * maxval + rng.normal(
            0.0, 0.02 * maxval, (h, w))
        out[k] = np.clip(np.rint(noisy), 0, maxval)
    return out


def volume_payload_bits(case: VolumeCase, lsb_bits: int) -> np.ndarray:
    """The volume case's payload as uint8 0/1 bits. ``lsb_bits`` — the
    volume's ``capacity_report`` LSB capacity — sizes the ``half`` cases
    and is ignored otherwise."""
    if case.payload == "text":
        return np.unpackbits(np.frombuffer(TEXT_PAYLOAD.encode(), np.uint8))
    nbits = (lsb_bits // 2 if case.payload == "half"
             else int(case.payload.split(":", 1)[1]))
    rng = np.random.default_rng(case.seed + 2000)
    return rng.integers(0, 2, nbits, dtype=np.uint8)


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


def pee_attempt_group_lists(t_start, t_final):
    """The equal-T groups the PEE encoders' escalation loop embeds, each
    with one K3 launch per pass, replayed from each image's first and final
    T: ``[(T, idxs), ...]`` in the order the loop runs them. A round visits
    the thresholds its pending images hold at its start, in ascending
    order; an image that falls short at T moves to T + 1 at once, so it
    joins the round's group at T + 1 if there is one (and is then pending
    twice in the next round, as in both packages' loop: a group of B
    entries can then hold an image twice)."""
    t_img = [int(t) for t in t_start]
    final = [int(t) for t in t_final]
    pending = list(range(len(t_img)))
    groups = []
    while pending:
        next_pending = []
        for t in sorted({t_img[i] for i in pending}):
            idxs = [i for i in pending if t_img[i] == t]
            groups.append((t, idxs))
            for i in idxs:
                if t < final[i]:
                    t_img[i] = t + 1
                    next_pending.append(i)
        pending = next_pending
    return groups


def pee_attempt_groups(t_start, t_final) -> int:
    """The number of groups :func:`pee_attempt_group_lists` replays."""
    return len(pee_attempt_group_lists(t_start, t_final))


def pee_group_shards(groups, dp: int, mesh_size: int):
    """The shard sizes of each attempt group of ``groups`` (as
    :func:`pee_attempt_group_lists` gives them) over a mesh of
    ``mesh_size`` devices with ``dp`` on its ``dp`` axis: the JAX package
    shards a group over ``dp`` when its power-of-two size ``g_pad`` is a
    multiple of the mesh's size, ``g_pad / dp`` rows a shard; the port pads
    nothing, so its last shards are shorter or empty, and K3 runs twice
    per non-empty shard. An unsharded group is one shard."""
    out = []
    for _, idxs in groups:
        g = len(idxs)
        g_pad = 1 << max(0, (g - 1).bit_length())
        if g_pad % mesh_size:
            out.append([g])
            continue
        k = g_pad // dp
        out.append([min(k, g - i * k) for i in range(dp) if g > i * k])
    return out


# The tiled path (parallel/tile.py, parallel/tile_pee.py): one image's rows
# split over K bands of a mesh. TILED_PEE runs the 2048x2048 PEE case over
# K in TILED_KS (the fixture's ``tiled`` section holds the JAX package's
# tiled container for each K); the 4096x3328 uint16 cases are a
# mammography frame, the largest common single-frame DICOM, over 4 bands:
# PEE with a payload that needs both passes, and the raster strategies.
TILED_PEE = "pee_cr2048_u16_3m"
TILED_KS = (1, 2, 4)
TILED_BIG = (
    Case("pee_mammo4096x3328_u16_6m", 4096, 3328, "uint16", 12,
         "bits:6000000", "pee", 41),
    Case("mammo4096x3328_u16_hybrid", 4096, 3328, "uint16", 12,
         "bits:2000000", "hybrid", 42),
    Case("blk_mammo4096x3328_u16", 4096, 3328, "uint16", 12, "bits:2000000",
         "block_adaptive", 43),
)
TILED_BIG_K = 4


def load_parity_tiled() -> Dict[str, dict]:
    """The fixture's ``tiled`` section: the JAX package's tiled containers
    and the F1 batch's containers."""
    with open(PARITY_JSON, encoding="utf-8") as f:
        return json.load(f)["tiled"]


# F1 (ROADMAP queue 3): a PEE batch whose escalation loop embeds a group of
# B entries that holds an image twice. Image 2 falls short at T=10 and at
# T=11 in one round, so the next round's group at T=12 is [2, 0, 2].
F1_THRESHOLD = 4          # EncodeConfig.pee_threshold
F1_GROUP = (12, [2, 0, 2])


def f1_batch():
    """``(images (3, 24, 38) uint16 at most 1023, payload bit arrays)`` of
    the F1 case, seeded: a ramp plus noise, payloads of 180-397 bits."""
    rng = np.random.default_rng(381)
    rng.integers(0, 1024, (3, 24, 38))   # the search's first draw
    base = int(rng.integers(200, 800))
    yy, xx = np.mgrid[0:24, 0:38]
    imgs = (base + 3 * yy + 2 * xx + rng.integers(-20, 21, (3, 24, 38)))
    imgs = imgs.clip(0, 1023).astype(np.uint16)
    sizes = rng.integers(150, 400, 3)
    return imgs, [rng.integers(0, 2, int(n), dtype=np.uint8) for n in sizes]


def sha256(data) -> str:
    if isinstance(data, np.ndarray):
        data = np.ascontiguousarray(data).tobytes()
    return hashlib.sha256(data).hexdigest()


def load_parity() -> Dict[str, dict]:
    with open(PARITY_JSON, encoding="utf-8") as f:
        return json.load(f)["cases"]


# The other transport codecs and STGC v1 (the fixture's ``codecs``
# section): ``jls`` on the images of six parity cases (same seeds and
# payloads), v1 + ``jls`` hybrid on ``mr512_u16``, and a ``jls`` volume of
# 8 x 512x512 uint16 hybrid with the 304-bit text. Only ``jls`` goes into
# the fixture: it is integer-exact C++ from one source, so its bytes are the
# same on every machine; png/j2k/jxl bytes depend on the Pillow and libjxl
# builds and are compared with the JAX package in one process only.
def _with(case: Case, name: str, *overrides) -> Case:
    return Case(name, case.height, case.width, case.dtype, case.bits_stored,
                case.payload, case.strategy, case.seed,
                case.overrides + tuple(overrides))


CODEC_CASES = tuple(
    _with(BY_NAME[base], f"jls_{base}", ("codec", "jls"))
    for base in ("mr512_u16", "ot512_u8", "odd640x480_u16", "cr2048_u16_full",
                 "pee_mr512_u16_text", "blk_mr512_u16")
) + (
    _with(BY_NAME["mr512_u16"], "jls_v1_mr512_u16", ("codec", "jls"),
          ("container_version", 1)),
)
CODEC_VOLUME = VolumeCase("jls_vol8_u16_hybrid_text", 8, 512, 512, "uint16",
                          12, "text", "hybrid", 45, "jls")

# The serving daemon (the fixture's ``serve`` section): requests on DICOM
# files (BitsStored 12) of the ``mr512_u16`` and ``pee_mr512_u16_text``
# images with the 304-bit text as "message", the default config and
# ``strategy: pee``, and ``codec: jls``; an ``encode_batch`` of four
# 512x512 uint16 images (:func:`serve_batch_images`) with the default
# config (the device route: one batch K1); an ``encode_volume`` of the
# deflate twin of :data:`CODEC_VOLUME` as ``.npy``; ``capacity`` on the
# ``mr512_u16`` file; ``analyze`` of that file against its stego.
SERVE_ENCODES = (("serve_mr512_u16", "mr512_u16", ()),
                 ("serve_pee_mr512_u16_text", "pee_mr512_u16_text", ()),
                 ("serve_jls_mr512_u16", "mr512_u16", (("codec", "jls"),)))
SERVE_VOLUME = VolumeCase("vol8_u16_hybrid_text", 8, 512, 512, "uint16", 12,
                          "text", "hybrid", 45)
SERVE_BATCH = 4


def serve_config(base: str, overrides) -> dict:
    """The request's ``config`` object of a :data:`SERVE_ENCODES` entry."""
    return {"strategy": BY_NAME[base].strategy, **dict(overrides)}


def serve_batch_images():
    """The four 512x512 uint16 images of the daemon's ``encode_batch``."""
    return [image(Case(f"serve_batch_{k}", 512, 512, "uint16", 12, "text",
                       "hybrid", 51 + k)) for k in range(SERVE_BATCH)]


def load_parity_codecs() -> Dict[str, dict]:
    with open(PARITY_JSON, encoding="utf-8") as f:
        return json.load(f)["codecs"]


def load_parity_serve() -> Dict[str, dict]:
    with open(PARITY_JSON, encoding="utf-8") as f:
        return json.load(f)["serve"]


def load_parity_volumes() -> Dict[str, dict]:
    """The volume, capacity and analyze entries of the fixture."""
    with open(PARITY_JSON, encoding="utf-8") as f:
        return json.load(f)["volumes"]
