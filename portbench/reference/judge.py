"""The comparison that decides ``correct``: what the timed path produced,
against the plain reference computed anew from the same inputs.

Every number is a count of disagreements, whose limit is 0, except
``metric_gap``: the largest relative gap of the port's MSE, PSNR and SSIM
(float32 moments on the card) to the reference's float64 ones, whose limit
the cell's workload file states.
"""

from __future__ import annotations

import numpy as np

from . import raster, stgc

EXACT = ("header_fields", "stego_px", "map_bits", "payload_bits",
         "restored_px")


def metric_gap(got: dict, want: dict) -> float:
    return max(abs(float(got[k]) - want[k]) / abs(want[k])
               for k in ("mse", "psnr", "ssim"))


def bit_errors(got, want: np.ndarray) -> int:
    """Payload bits that differ, a missing or extra bit counting as one."""
    got = np.asarray(got, np.uint8).ravel()
    m = min(got.size, want.size)
    return int((got[:m] != want[:m]).sum()) + abs(got.size - want.size)


def pixel_errors(got, want: np.ndarray) -> int:
    if got is None or np.shape(got) != want.shape:
        return int(want.size)
    return int((np.asarray(got) != want).sum())


def _container(parsed: dict, ref: dict) -> dict:
    return {
        "header_fields": len(raster.header_mismatches(parsed, ref["header"])),
        "stego_px": pixel_errors(stgc.inflate_stego(parsed["stego_blob"]),
                                 ref["stego"]),
        "map_bits": raster.count_map_bits(
            stgc.inflate_maps(parsed["bitmaps_blob"]), ref["maps"]),
    }


def image(ref_mod, cfg: dict, img: np.ndarray, bits: np.ndarray,
          container: bytes, payload, original, metrics: dict,
          device) -> dict:
    """One image's encode and decode against the reference."""
    ref = ref_mod.encode_image(img, bits, cfg, device=device)
    out = _container(stgc.parse_stgc(container), ref)
    out["payload_bits"] = bit_errors(payload, bits)
    out["restored_px"] = pixel_errors(original, img)
    out["metric_gap"] = metric_gap(metrics, ref["metrics"])
    return out


def volume(cfg: dict, vol: np.ndarray, bits: np.ndarray, stgv: bytes,
           payloads, original, metrics: dict) -> dict:
    """A volume's STGV file, its decoded payload (every read of it) and
    restored series against the reference."""
    ref = raster.encode_volume(vol, bits, cfg)
    got = stgc.parse_stgv(stgv)
    head = {k: got[k] for k in ref["volume_header"]}
    out = {"header_fields": len(raster.header_mismatches(
        head, ref["volume_header"])), "stego_px": 0, "map_bits": 0}
    if got["depth"] != vol.shape[0]:
        out["stego_px"] = int(vol.size)
    for blob, want in zip(got["slices"], ref["slices"]):
        for k, v in _container(stgc.parse_stgc(blob), want).items():
            out[k] += v
    out["payload_bits"] = sum(bit_errors(p, bits) for p in payloads)
    out["restored_px"] = pixel_errors(original, vol)
    out["metric_gap"] = metric_gap(metrics, ref["metrics"])
    return out


def merge(readings: list) -> dict:
    """Counts summed, the gap's largest, over the judged units."""
    out = {k: sum(r[k] for r in readings) for k in EXACT}
    out["metric_gap"] = max(r["metric_gap"] for r in readings)
    return out
