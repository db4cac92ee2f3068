"""The port's tile-sharded PEE (``parallel/tile_pee.py``) against the
benchmark's plain reference (``portbench/reference/pee.py``, written from
the scheme's description, sharing no code with the port), on a CPU
``tile`` mesh: the tiled container, decoded payload and restored original
are judged as the benchmark judges them (``judge.image``, every count 0,
``metric_gap`` under 1e-5), and the container equals
``pipeline.encode_array``'s, over K = 1, 2, 4 and 7 bands (at 7 bands a
36-row frame leaves the last band empty), four frames, both dtypes and
three payloads: one pass, both passes, and a threshold that rises; a
band that reads its own edge row for its neighbour's is caught; and the
route's spans and counters count its passes and its codec's side."""

import numpy as np
import pytest
import torch

from codec_tcc_tpu_torch import EncodeConfig, pipeline, profiling
from codec_tcc_tpu_torch.parallel import make_mesh, tile, tile_pee

pytest.importorskip("portbench")
from portbench.reference import judge, stgc  # noqa: E402
from portbench.reference import pee as pee_ref  # noqa: E402
from portbench.traffic import generator  # noqa: E402

torch.set_num_threads(1)

BITS_STORED = {"uint8": 8, "uint16": 12}
FRAMES = ((61, 67), (96, 128), (128, 96), (36, 67))
LOADS = ("text", "both", "rise")
CASES = [(h, w, dt, k, load) for h, w in FRAMES for dt in BITS_STORED
         for k in (1, 2, 4, 7) for load in LOADS]


def _frame(h, w, dtype):
    """The generator's phantom with noise of 2 grey levels (the benchmark's
    2% of full scale leaves too few errors under T = 2 for a one-pass
    payload at these sizes), clipped to BitsStored: the bone saturates, so
    the overflow map has pixels."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    y, x = (y - h / 2) / (h / 2), (x - w / 2) / (w / 2)
    body = ((x / 0.85) ** 2 + (y / 0.75) ** 2 < 1.0) * 0.45
    organ = ((x + 0.3) ** 2 / 0.04 + y ** 2 / 0.09 < 1.0) * 0.25
    bone = ((x - 0.35) ** 2 + (y + 0.2) ** 2 < 0.01) * 0.35
    smooth = 0.05 + body + organ + bone + 0.1 * (x + 1.0)
    top = (1 << BITS_STORED[dtype]) - 1
    rng = np.random.default_rng(h * w + top)
    return np.clip(np.rint(smooth * top + rng.normal(0.0, 2.0, (h, w))),
                   0, top).astype(dtype)


def _cfg(dtype):
    return {"strategy": "pee", "codec": "deflate", "seed": 42,
            "pee_threshold": 2, "bits_stored": BITS_STORED[dtype]}


def _estimates(img, cfg):
    """Pass 0's exact capacity plus pass 1's on the unmarked image, by T."""
    x = torch.from_numpy(img.astype(np.int32))
    top = (1 << cfg["bits_stored"]) - 1
    return pee_ref.capacities(x, 0, top) + pee_ref.capacities(x, 1, top)


def _rising_payload(img, cfg) -> int:
    """The least estimate ``comb[T0 - 1]`` (T0 above the configured start)
    that the reference embeds only past T0: pass 1 on pass 0's output
    holds less than the estimate, so T rises."""
    comb = _estimates(img, cfg)
    for t0 in range(cfg["pee_threshold"] + 1, pee_ref.MAX_T + 1):
        n = int(comb[t0 - 1])
        if n <= comb[t0 - 2]:
            continue
        ref = pee_ref.encode_image(img, generator.payload(n, 3, 0, 0), cfg)
        if stgc.pee_ext(ref["header"]["ext"])[0] > t0:
            return n
    raise AssertionError("no payload makes T rise on this frame")


def _payload(img, cfg, load):
    n = {"text": lambda: 304,
         "both": lambda: int(0.7 * _estimates(img, cfg)[-1]),
         "rise": lambda: _rising_payload(img, cfg)}[load]()
    return generator.payload(n, 3, 0, 0)


def _mesh(k):
    return make_mesh(devices=["cpu"] * k, axes=("tile",))


def _judge(img, bits, cfg, k):
    mesh = _mesh(k)
    port_cfg = EncodeConfig(strategy="pee")
    res = tile_pee.encode_array_tiled_pee(img, bits, port_cfg, mesh,
                                          bits_stored=cfg["bits_stored"])
    dec = tile_pee.decode_container_tiled_pee(res.container, mesh,
                                              restore_original=True)
    out = judge.image(pee_ref, cfg, img, bits, res.container,
                      dec.payload_bits, dec.original, res.metrics, "cpu")
    return res, out


@pytest.mark.parametrize("h,w,dtype,k,load", CASES,
                         ids=[f"{h}x{w}-{dt}-k{k}-{ld}"
                              for h, w, dt, k, ld in CASES])
def test_tiled_pee_agrees_with_the_reference(h, w, dtype, k, load):
    img = _frame(h, w, dtype)
    cfg = _cfg(dtype)
    bits = _payload(img, cfg, load)
    res, out = _judge(img, bits, cfg, k)
    assert all(out[key] == 0 for key in judge.EXACT), out
    assert 0 <= out["metric_gap"] < 1e-5, out
    single = pipeline.encode_array(img, bits, EncodeConfig(strategy="pee"),
                                   bits_stored=cfg["bits_stored"],
                                   device="cpu")
    assert res.container == single.container
    t, passes = stgc.pee_ext(stgc.parse_stgc(res.container)["ext"])[:2]
    assert passes == {"text": 1, "both": 2, "rise": 2}[load]
    if load == "rise":
        first = int(np.nonzero(_estimates(img, cfg)[1:] >= bits.size)[0][0])
        assert t > first + 2
    if (h, k) == (36, 7):
        bands = tile.split_rows(img, _mesh(k))
        assert bands[-1].numel() == 0 and bands[-2].numel() > 0


def test_a_band_that_reads_its_own_edge_for_its_neighbours_is_caught(
        monkeypatch):
    """Each band's halo rows replaced by its own first and last rows: the
    rows beside a band edge predict from the wrong pixels, so the stego
    differs from the reference's there."""
    img = _frame(96, 128, "uint16")
    cfg = _cfg("uint16")
    bits = _payload(img, cfg, "both")
    assert all(v == 0 for key, v in _judge(img, bits, cfg, 4)[1].items()
               if key in judge.EXACT)

    def own_edges(bands, k):
        band = bands[k]
        return band[:1], band[-1:]

    monkeypatch.setattr(tile_pee, "_halo_rows", own_edges)
    out = _judge(img, bits, cfg, 4)[1]
    assert out["stego_px"] > 0, out


def test_spans_and_counters_of_the_tiled_route():
    """One request on a CPU mesh of 4: the stages have walls, each
    ``band_pass`` nests inside ``embed`` or ``extract``, ``tile.band_passes``
    counts every attempt's passes and the decode's inverse passes, and the
    stego goes through the host codec both ways."""
    img = _frame(96, 128, "uint16")
    cfg = _cfg("uint16")
    bits = _payload(img, cfg, "rise")
    mesh = _mesh(4)
    prof = profiling.get_profiler()
    prof.reset()
    profiling.enable()
    try:
        res = tile_pee.encode_array_tiled_pee(img, bits,
                                              EncodeConfig(strategy="pee"),
                                              mesh, bits_stored=12)
        tile_pee.decode_container_tiled_pee(res.container, mesh)
    finally:
        profiling.disable()
    walls = prof.wall
    for name in ("encode_array_tiled_pee", "decode_container_tiled_pee",
                 "image_upload", "pee_histogram", "embed", "band_pass",
                 "extract", "transport_codec", "transport_decode",
                 "restore"):
        assert walls.get(name, 0) > 0, name
    spans = {s.span_id: s for s in prof.spans}
    nested = [spans[s.parent_id].name for s in prof.spans
              if s.name == "band_pass"]
    assert set(nested) == {"embed", "extract"}
    passes = stgc.pee_ext(stgc.parse_stgc(res.container)["ext"])[1]
    c = profiling.counters()
    attempts = c["tile.attempts"]
    assert attempts >= 2 and passes == 2
    # a failed attempt ran both passes; the last ran ``passes``; the decode
    # inverts ``passes``
    assert c["tile.band_passes"] == 2 * (attempts - 1) + 2 * passes
    assert c["tile.band_passes"] == prof.calls["band_pass"] == len(nested)
    assert c["tile.bands"] == 4 * c["tile.band_passes"]
    assert c.get("codec.deflate_host") == 1 and c.get("codec.inflate_host") == 1
    assert "codec.deflate_device" not in c and "codec.inflate_device" not in c
    prof.reset()
