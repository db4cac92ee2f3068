"""Write ``tests/data/torch_port_parity.json``: the JAX package's containers
for every case of ``tests/torch_port_cases.py``, as hashes.

Each case's ``EncodeConfig`` is the default with its strategy and its
overrides (``Case.config``). Per case it records the cut point ``s`` (0 for ``pee``), the payload size
and sha256 (of the uint8 0/1 bit array), the container's length and
sha256 and, for ``pee``, the PEE ext ``(T, passes, nproc0, nproc1, bits0,
bits1)``, so that a mismatch says which pass differed; all from
``codec_tcc_tpu.encode_array`` on the CPU. The torch port must reproduce
them byte for byte (``chip_smoke.py`` on the GPU,
``tests/test_torch_pipeline.py`` on the CPU).

Under ``volumes`` it records, per volume case, the STGV file of
``codec_tcc_tpu.parallel.volume.encode_volume`` + ``pack_volume`` (length
and sha256), the global cut point (0 for ``pee``), the PEE threshold, the
volume's LSB capacity that sizes the ``half`` payloads, and the payload's
size and sha256; the volume quality reports of ``VOLUME_METRICS_CASES``
(``metrics_<case>``); the JAX CLI's ``analyze --windowed-ssim`` report of
``cli_analyze_pair``; then the ``capacity_report`` dicts and the
``analyze_pair`` reports of ``tests/torch_port_cases.py``.

Under ``tiled`` it records the JAX package's tiled PEE container of the
2048x2048 case over 1, 2 and 4 bands (``parallel.tile_pee``, XLA route, on
a mesh of host devices) and the containers of the F1 batch
(``torch_port_cases.f1_batch``).

Regenerate from the repository root with:

    JAX_PLATFORMS=cpu python tests/make_torch_port_fixtures.py
"""

from __future__ import annotations

import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

# the tiled entries run on a mesh of 8 host devices, as the JAX tests do
os.environ.setdefault("JAX_PLATFORMS", "cpu")
if "xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS",
                                                                 ""):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                               " --xla_force_host_platform_device_count=8")

import torch_port_cases as cases  # noqa: E402


def jax_entry(case: cases.Case) -> dict:
    """Encode one case with the JAX package; return its JSON entry."""
    from codec_tcc_tpu import EncodeConfig, encode_array
    from codec_tcc_tpu.io.container import parse_pee_ext
    from codec_tcc_tpu.ops.decompose import decompose
    from codec_tcc_tpu.ops.segments import usable_capacity_bits

    img = cases.image(case)
    if case.strategy == "pee":
        s, capacity = 0, 0      # PEE has no cut point
    else:
        s = decompose(img, beta=0.4, nbits=case.bits_stored).s
        capacity = usable_capacity_bits(s, img.size, 42)
    bits = cases.payload_bits(case, capacity)
    res = encode_array(
        img, bits, case.config(EncodeConfig), bits_stored=case.bits_stored,
    )
    assert res.s == s
    entry = {
        "s": int(s),
        "payload_bits": int(bits.size),
        "payload_sha256": cases.sha256(bits),
        "container_len": len(res.container),
        "container_sha256": cases.sha256(res.container),
    }
    if case.strategy == "pee":
        entry["pee_ext"] = [int(v) for v in parse_pee_ext(res.meta.ext)]
    return entry


def volume_lsb_bits(vol) -> int:
    """The volume's LSB capacity as ``capacity_report`` gives it: the usable
    bits per slice at the global cut point, times the slices."""
    from codec_tcc_tpu.ops.segments import usable_capacity_bits
    from codec_tcc_tpu.parallel.volume import volume_cut_point

    s, _ = volume_cut_point(vol, 0.4)
    return usable_capacity_bits(s, vol.shape[1] * vol.shape[2], 42) * (
        vol.shape[0])


def volume_entry(case: cases.VolumeCase, metrics: dict) -> dict:
    """Encode and pack one volume case with the JAX package; a case of
    ``VOLUME_METRICS_CASES`` puts its quality report into ``metrics``."""
    from codec_tcc_tpu import EncodeConfig
    from codec_tcc_tpu.parallel import volume as volume_par

    vol = cases.volume(case)
    lsb_bits = volume_lsb_bits(vol)
    bits = cases.volume_payload_bits(case, lsb_bits)
    cfg = case.config(EncodeConfig)
    t0 = time.perf_counter()
    res = volume_par.encode_volume(vol, bits, cfg)
    blob = volume_par.pack_volume(vol, res, cfg)
    print(f"{case.name}: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    if case.name in cases.VOLUME_METRICS_CASES:
        assert int(res.stego.max()) == int(vol.max()), (
            f"{case.name}: the stego's maximum moved; its report would not "
            "be the equal-range branch")
        metrics[f"metrics_{case.name}"] = res.metrics
    return {
        "s": int(res.s),
        "threshold": None if res.threshold is None else int(res.threshold),
        "lsb_bits": int(lsb_bits),
        "slice_bits": [int(v) for v in res.slice_bits],
        "payload_bits": int(bits.size),
        "payload_sha256": cases.sha256(bits),
        "stgv_len": len(blob),
        "stgv_sha256": cases.sha256(blob),
    }


def capacity_entry(source: str) -> dict:
    from codec_tcc_tpu.pipeline import capacity_report

    if source in cases.BY_NAME:
        case = cases.BY_NAME[source]
        return capacity_report(cases.image(case), bits_stored=case.bits_stored)
    return capacity_report(cases.volume(cases.VOLUMES_BY_NAME[source]))


def analyze_entry(source: str, ranges: str) -> dict:
    from codec_tcc_tpu import EncodeConfig, analyze_pair, encode_array
    from codec_tcc_tpu.ops.decompose import decompose
    from codec_tcc_tpu.ops.segments import usable_capacity_bits

    case = cases.BY_NAME[source]
    img = cases.image(case)
    s = decompose(img, beta=0.4, nbits=case.bits_stored).s
    bits = cases.payload_bits(case, usable_capacity_bits(s, img.size, 42))
    stego = encode_array(img, bits, case.config(EncodeConfig),
                         bits_stored=case.bits_stored).stego
    return {"stego_sha256": cases.sha256(stego),
            "report": analyze_pair(img, stego, **cases.ANALYZE_RANGES[ranges])}


def cli_analyze_entry() -> dict:
    """The JAX CLI's ``analyze --windowed-ssim --report`` on the pair of
    ``cases.cli_analyze_pair``."""
    import contextlib
    import tempfile

    from codec_tcc_tpu import cli
    from codec_tcc_tpu.io.dicom import save_image

    with tempfile.TemporaryDirectory() as tmp:
        orig, stego = cases.cli_analyze_pair(save_image, tmp)
        report = os.path.join(tmp, "r.json")
        with contextlib.redirect_stdout(sys.stderr):
            assert cli.main(["analyze", orig, stego, "--windowed-ssim",
                             "--report", report]) == 0
        with open(report, encoding="utf-8") as f:
            return {"report": json.load(f)}


def tiled_entries() -> dict:
    """The JAX package's tiled PEE container of ``TILED_PEE`` over each K of
    ``TILED_KS`` (``encode_array_tiled_pee``, XLA route, on the first K
    host devices) and the containers of the F1 batch
    (``parallel.batch_pee.encode_pee_batch``)."""
    from codec_tcc_tpu import EncodeConfig
    from codec_tcc_tpu.parallel import batch_pee, mesh, tile_pee

    out = {}
    case = cases.BY_NAME[cases.TILED_PEE]
    img = cases.image(case)
    bits = cases.payload_bits(case, 0)
    for k in cases.TILED_KS:
        res = tile_pee.encode_array_tiled_pee(
            img, bits, case.config(EncodeConfig),
            mesh.make_mesh(k, ("tile",)), bits_stored=case.bits_stored,
            backend="xla")
        out[f"{case.name}_k{k}"] = {
            "container_len": len(res.container),
            "container_sha256": cases.sha256(res.container),
        }
    imgs, pays = cases.f1_batch()
    res = batch_pee.encode_pee_batch(
        imgs, pays, EncodeConfig(strategy="pee",
                                 pee_threshold=cases.F1_THRESHOLD))
    out["f1_pee_batch"] = {
        "container_sha256": [cases.sha256(c) for c in res.containers],
        "thresholds": [int(t) for t in res.thresholds],
    }
    return out


def main() -> int:
    metrics: dict = {}
    volumes = {
        **{c.name: volume_entry(c, metrics) for c in cases.VOLUME_CASES},
        **metrics,
        cases.CLI_ANALYZE_CASE: cli_analyze_entry(),
        **{name: capacity_entry(src) for name, src in cases.CAPACITY_CASES},
        **{name: analyze_entry(src, r) for name, src, r
           in cases.ANALYZE_CASES},
    }
    out = {
        "generator": "tests/make_torch_port_fixtures.py",
        "reference": "codec_tcc_tpu.encode_array, EncodeConfig defaults "
                     "except strategy and each case's overrides, container "
                     "v2, deflate; volumes: "
                     "codec_tcc_tpu.parallel.volume.encode_volume + "
                     "pack_volume (and VolumeResult.metrics), "
                     "cli analyze --windowed-ssim --report, "
                     "pipeline.capacity_report, pipeline.analyze_pair",
        "cases": {c.name: jax_entry(c) for c in cases.CASES},
        "volumes": volumes,
        "tiled": tiled_entries(),
    }
    if os.path.exists(cases.PARITY_JSON):
        # a new case must not move an entry already committed
        with open(cases.PARITY_JSON, encoding="utf-8") as f:
            committed = json.load(f)
        for section in ("cases", "volumes", "tiled"):
            for name, entry in committed.get(section, {}).items():
                assert out[section].get(name) == entry, (
                    f"{name}: the regenerated entry differs from the "
                    f"committed one: {out[section].get(name)} != {entry}")
    with open(cases.PARITY_JSON, "w", encoding="utf-8") as f:
        json.dump(out, f, indent=1, sort_keys=True)
        f.write("\n")
    print(json.dumps({k: out[k] for k in ("cases", "volumes", "tiled")},
                     indent=1, sort_keys=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
