# Port of codec_tcc_tpu/serve.py: the same ops, protocol, error answers,
# stale-socket probe, SIGTERM and timeouts; every function but _op_ping is
# the same code but for the device it passes. The daemon keeps its device
# in `state` and hands it to every entry point it calls; ping reports that
# device's type. _handle_line opens a profiling request span per request
# and takes the reply's wall_ms from it.
"""Warm serving daemon: line-delimited JSON over a Unix domain socket.

A per-request CLI pays process start, the first CUDA contact and the
kernel library's load on every invocation. One resident daemon pays them
once and is the unit of card ownership for serving (one daemon per card;
batch requests route to the one-launch-per-batch device paths). Every
request runs on the daemon's ``device`` (``"cuda"`` unless it was started
with ``"cpu"``).

Protocol: connect to the socket, send one JSON object per line, read one
JSON response line per request (in order). Responses always carry
``"ok"``; failures carry ``"error"``/``"error_type"`` and never kill the
daemon. Operations:

    {"op": "ping"}
    {"op": "encode", "input": p, "output": p, "message"|"payload_b64": ...,
     "config": {beta, strategy, codec, ...}}          # EncodeConfig fields
    {"op": "decode", "input": p, "output_prefix": p, "restore": true}
    {"op": "encode_batch", "inputs": [...], "output_dir": d,
     "message"|"payload_b64": ..., "config": {...}}   # one batch per group
    {"op": "decode_batch", "inputs": [...], "output_dir": d}
    {"op": "encode_volume", "inputs": [...], "output": p,
     "message"|"payload_b64": ..., "config": {...}}    # STGV container
    {"op": "decode_volume", "input": p, "output_prefix": p, "dicom": false}
    {"op": "analyze", "original": p, "stego": p}
    {"op": "capacity", "input": p, "beta"|"nbits"|"pee_threshold"|...: ...}
    {"op": "shutdown"}

Start:  python -m codec_tcc_tpu_torch serve --socket ct.sock [--warmup 512x512] [--device cpu]
Client: codec_tcc_tpu_torch.serve.request("ct.sock", {"op": "ping"})
"""

from __future__ import annotations

import base64
import json
import os
import socket
import time
from dataclasses import fields
from typing import Optional

import numpy as np

from . import profiling
from .config import EncodeConfig
from .utils.logging import get_logger

logger = get_logger("serve")

_CONFIG_FIELDS = {f.name for f in fields(EncodeConfig)}


def _parse_config(obj: dict) -> EncodeConfig:
    cfg = obj.get("config", {})
    if not isinstance(cfg, dict):
        raise ValueError("'config' must be an object of EncodeConfig fields")
    unknown = set(cfg) - _CONFIG_FIELDS
    if unknown:
        raise ValueError(
            f"unknown config fields {sorted(unknown)}; "
            f"valid: {sorted(_CONFIG_FIELDS)}"
        )
    return EncodeConfig(**cfg).validate()


def _parse_payload(obj: dict):
    """Payload from a request: 'message' (text) or 'payload_b64' (binary)."""
    has_msg = "message" in obj
    has_b64 = "payload_b64" in obj
    if has_msg == has_b64:
        raise ValueError("exactly one of 'message'/'payload_b64' is required")
    if has_msg:
        return obj["message"]
    return base64.b64decode(obj["payload_b64"], validate=True)


def _op_ping(obj: dict, state: dict) -> dict:
    import torch

    dev = torch.device(state["device"])
    return {
        "backend": dev.type,
        "device_count": (
            torch.cuda.device_count() if dev.type == "cuda" else 1
        ),
        "uptime_s": round(time.monotonic() - state["t0"], 1),
        "requests_served": state["served"],
        "ops_served": dict(state["op_counts"]),
        "pid": os.getpid(),
    }


def _op_encode(obj: dict, state: dict) -> dict:
    from . import pipeline

    cfg = _parse_config(obj)
    result = pipeline.encode_file(obj["input"], _parse_payload(obj), cfg,
                                  device=state["device"])
    with open(obj["output"], "wb") as f:
        f.write(result.container)
    out = {
        "output": obj["output"],
        "s": result.s,
        "strategy": result.meta.strategy,
        "codec": result.meta.codec,
        "payload_bits": result.meta.payload_bits,
        "container_bytes": len(result.container),
    }
    if result.metrics:
        out["metrics"] = result.metrics
    return out


def _op_decode(obj: dict, state: dict) -> dict:
    from . import pipeline
    from .cli import _write_payload
    from .io import dicom

    restore = bool(obj.get("restore", True))
    result = pipeline.decode_file(obj["input"], restore_original=restore,
                                  device=state["device"])
    prefix = obj.get("output_prefix")
    out = {"payload_bits": int(result.payload_bits.size)}
    if prefix:
        out["payload_path"] = _write_payload(result.payload, prefix)
        stego_path = f"{prefix}_stego.dcm"
        dicom.save_image(result.stego, stego_path)
        out["stego_path"] = stego_path
        if result.original is not None:
            orig_path = f"{prefix}_original.dcm"
            dicom.save_image(result.original, orig_path)
            out["original_path"] = orig_path
    else:
        # no files requested: hand the payload back inline
        out["payload_b64"] = base64.b64encode(result.payload).decode("ascii")
    return out


def _op_encode_batch(obj: dict, state: dict) -> dict:
    from .cli import encode_fused_buckets

    cfg = _parse_config(obj)
    paths = obj["inputs"]
    if not isinstance(paths, list) or not paths:
        raise ValueError("'inputs' must be a non-empty list of paths")
    payload = _parse_payload(obj)
    # one fused dispatch per (geometry, dtype, BitsStored) group — same
    # bucketing as CLI encode-batch --fused (cli.load_fused_buckets)
    records = encode_fused_buckets(paths, payload, cfg, device=state["device"])
    out_dir = obj["output_dir"]
    os.makedirs(out_dir, exist_ok=True)
    items = []
    for rec in records:
        dst = os.path.join(
            out_dir,
            os.path.splitext(os.path.basename(rec["input"]))[0] + ".stgc",
        )
        with open(dst, "wb") as f:
            f.write(rec["container"])
        item = {"input": rec["input"], "output": dst,
                "container_bytes": len(rec["container"])}
        if rec["s"] is not None:
            item["s"] = rec["s"]
        if rec["psnr"] is not None:
            item["psnr"] = rec["psnr"]
        items.append(item)
    return {"items": items, "fused": True}


def _op_decode_batch(obj: dict, state: dict) -> dict:
    from .cli import _write_payload
    from .io import dicom
    from .parallel.batch import decode_batch_containers

    paths = obj["inputs"]
    if not isinstance(paths, list) or not paths:
        raise ValueError("'inputs' must be a non-empty list of paths")
    blobs = []
    for path in paths:
        with open(path, "rb") as f:
            blobs.append(f.read())
    restore = bool(obj.get("restore", True))
    decs = decode_batch_containers(blobs, restore_original=restore,
                                   device=state["device"])
    out_dir = obj["output_dir"]
    os.makedirs(out_dir, exist_ok=True)
    items = []
    for path, dec in zip(paths, decs):
        stem = os.path.splitext(os.path.basename(path))[0]
        item = {
            "input": path,
            "payload_bits": int(dec.payload_bits.size),
            "payload_path": _write_payload(
                dec.payload, os.path.join(out_dir, stem)
            ),
        }
        if dec.original is not None:
            dst = os.path.join(out_dir, f"{stem}_original.dcm")
            dicom.save_image(dec.original, dst)
            item["original_path"] = dst
        items.append(item)
    return {"items": items}


def _op_encode_volume(obj: dict, state: dict) -> dict:
    from .cli import _load_volume
    from .parallel import volume as volume_par

    cfg = _parse_config(obj)
    paths = obj["inputs"]
    if not isinstance(paths, list) or not paths:
        raise ValueError("'inputs' must be a non-empty list of paths")
    vol = _load_volume(paths)
    result = volume_par.encode_volume(vol, _parse_payload(obj), cfg,
                                      device=state["device"])
    blob = volume_par.pack_volume(vol, result, cfg, device=state["device"])
    with open(obj["output"], "wb") as f:
        f.write(blob)
    out = {
        "output": obj["output"],
        "slices": int(vol.shape[0]),
        "payload_bits": int(result.slice_bits.sum()),
        "container_bytes": len(blob),
    }
    if result.threshold is not None:
        out["pee_threshold"] = result.threshold
    else:
        out["s"] = result.s
    if result.metrics:
        out["metrics"] = result.metrics
    return out


def _op_decode_volume(obj: dict, state: dict) -> dict:
    from .io import dicom
    from .parallel import volume as volume_par
    from .utils import bits as bit_utils

    with open(obj["input"], "rb") as f:
        data = f.read()
    payload_bits, stego, original = volume_par.unpack_volume(
        data, device=state["device"])
    prefix = obj["output_prefix"]
    payload_path = f"{prefix}_payload.bin"
    with open(payload_path, "wb") as f:
        f.write(bit_utils.bits_to_bytes(payload_bits))
    stego_path = f"{prefix}_stego.npy"
    np.save(stego_path, stego)
    out = {
        "payload_bits": int(payload_bits.size),
        "payload_path": payload_path,
        "stego_path": stego_path,
    }
    if original is not None:
        out["original_path"] = f"{prefix}_original.npy"
        np.save(out["original_path"], original)
    if obj.get("dicom"):
        # multiframe secondary-capture DICOMs, like the CLI's --dicom
        out["stego_dicom"] = f"{prefix}_stego.dcm"
        dicom.save_image(stego, out["stego_dicom"])
        if original is not None:
            out["original_dicom"] = f"{prefix}_original.dcm"
            dicom.save_image(original, out["original_dicom"])
    return out


def _op_capacity(obj: dict, state: dict) -> dict:
    from . import pipeline

    path = obj["input"]
    arr, bits_stored = pipeline.load_input(path)
    kwargs = {
        k: obj[k]
        for k in ("beta", "seed", "nbits", "use_bits_stored", "pee_threshold")
        if k in obj
    }
    out = {"input": path}
    out.update(pipeline.capacity_report(arr, bits_stored=bits_stored, **kwargs,
                                        device=state["device"]))
    return out


def _op_analyze(obj: dict, state: dict) -> dict:
    from . import pipeline
    from .analyze import _verdicts
    from .cli import _load_any

    orig = _load_any(obj["original"])
    stego = _load_any(obj["stego"])
    if orig.shape != stego.shape:
        raise ValueError(f"Shape mismatch: {orig.shape} vs {stego.shape}")
    rep = pipeline.analyze_pair(orig, stego, device=state["device"])
    quality, structure = _verdicts(rep)
    rep["verdict"] = f"{quality}; {structure}"
    return rep


_OPS = {
    "ping": _op_ping,
    "encode": _op_encode,
    "decode": _op_decode,
    "encode_batch": _op_encode_batch,
    "decode_batch": _op_decode_batch,
    "encode_volume": _op_encode_volume,
    "decode_volume": _op_decode_volume,
    "analyze": _op_analyze,
    "capacity": _op_capacity,
}


def _handle_line(line: bytes, state: dict) -> tuple:
    """Returns ``(response dict, shutdown?)``; never raises."""
    try:
        obj = json.loads(line)
        if not isinstance(obj, dict):
            raise ValueError("request must be a JSON object")
        op = obj.get("op")
        if op == "shutdown":
            return {"ok": True, "op": "shutdown"}, True
        if op not in _OPS:
            raise ValueError(
                f"unknown op {op!r}; valid: {sorted(_OPS) + ['shutdown']}"
            )
        with profiling.request("serve." + op) as span:
            out = _OPS[op](obj, state)
        out.update(ok=True, op=op, wall_ms=round(span.wall_ms, 2))
        state["served"] += 1
        state["op_counts"][op] = state["op_counts"].get(op, 0) + 1
        return out, False
    except Exception as exc:  # any failure answers; the daemon survives
        logger.warning("request failed: %s: %s", type(exc).__name__, exc)
        return {
            "ok": False,
            "error": str(exc)[:500],
            "error_type": type(exc).__name__,
        }, False


def _warmup(spec: str, device="cuda") -> None:
    """Pay the first device contact before the first real request:
    encode+decode a synthetic image per requested HxW geometry
    (comma-separated for mixed-size production traffic, e.g.
    ``512x512,640x480``) with the default config on ``device``. On the card
    that also builds and loads the kernel library (K1 and K2 run once per
    geometry)."""
    from . import pipeline

    for one in spec.lower().split(","):
        one = one.strip()
        if not one:
            continue
        h, w = (int(x) for x in one.split("x"))
        rng = np.random.default_rng(0)
        img = rng.integers(0, 4096, size=(h, w)).astype(np.uint16)
        t0 = time.perf_counter()
        res = pipeline.encode_array(img, b"warmup", EncodeConfig(),
                                    device=device)
        pipeline.decode_container(res.container, device=device)
        logger.info("warmup %s done in %.1fs", one, time.perf_counter() - t0)


def serve(
    socket_path: str,
    warmup: Optional[str] = None,
    idle_timeout: Optional[float] = None,
    conn_timeout: float = 600.0,
    device="cuda",
) -> int:
    """Run the daemon until a ``shutdown`` request (or ``idle_timeout``
    seconds without a connection). One connection is served at a time — the
    card serializes device work anyway, and in-order responses keep the
    protocol trivial. A connection that goes silent for ``conn_timeout``
    seconds is dropped (it would otherwise hold the daemon hostage, since
    nothing else can be accepted while it is open); SIGTERM exits cleanly
    (socket unlinked) so orchestrated restarts don't leave stale paths
    behind. Every request runs on ``device``."""
    import signal

    if warmup:
        _warmup(warmup, device=device)
    if os.path.exists(socket_path):
        # only remove a STALE socket: unlinking a live daemon's path would
        # orphan it (still running, still owning the card, unreachable)
        probe = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        probe.settimeout(2.0)
        try:
            probe.connect(socket_path)
        except OSError:
            os.unlink(socket_path)  # nothing listening: previous daemon died
        else:
            raise RuntimeError(
                f"a daemon is already serving on {socket_path}; shut it "
                "down first (one daemon per chip)"
            )
        finally:
            probe.close()
    srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)

    def _sigterm(signum, frame):
        raise SystemExit(0)  # unwinds through finally: socket unlinked

    try:
        prev_handler = signal.signal(signal.SIGTERM, _sigterm)
    except ValueError:
        # not the main thread: embedded mode (e.g. chip_smoke.py's
        # in-process daemon — one process owns the card AND the socket).
        # Lifecycle is then the embedder's job; the shutdown op still works.
        prev_handler = None
    try:
        srv.bind(socket_path)
        srv.listen(8)
        srv.settimeout(idle_timeout)
        state = {"t0": time.monotonic(), "served": 0, "op_counts": {},
                 "device": device}
        logger.info("serving on %s (pid %d)", socket_path, os.getpid())
        print(f"serving on {socket_path}", flush=True)  # readiness signal
        shutdown = False
        while not shutdown:
            try:
                conn, _ = srv.accept()
            except socket.timeout:
                logger.info("idle timeout (%.0fs); exiting", idle_timeout)
                break
            conn.settimeout(conn_timeout)
            try:
                with conn, conn.makefile("rwb") as f:
                    for line in f:
                        if not line.strip():
                            continue
                        resp, shutdown = _handle_line(line, state)
                        f.write(json.dumps(resp).encode() + b"\n")
                        f.flush()
                        if shutdown:
                            break
            except (socket.timeout, BrokenPipeError, ConnectionError) as exc:
                logger.warning("dropping connection: %s", exc)
        return 0
    finally:
        if prev_handler is not None:
            signal.signal(signal.SIGTERM, prev_handler)
        srv.close()
        if os.path.exists(socket_path):
            os.unlink(socket_path)


def request(socket_path: str, obj: dict, timeout: float = 600.0) -> dict:
    """One request/response round trip (client helper; used by the tests)."""
    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as c:
        c.settimeout(timeout)
        c.connect(socket_path)
        with c.makefile("rwb") as f:
            f.write(json.dumps(obj).encode() + b"\n")
            f.flush()
            line = f.readline()
    if not line:
        raise ConnectionError("daemon closed the connection without a response")
    return json.loads(line)
