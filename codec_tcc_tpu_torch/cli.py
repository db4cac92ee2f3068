# Port of codec_tcc_tpu/cli.py: the encode, decode, encode-batch and
# decode-batch subcommands, with the same flags, output lines, files and
# exit codes plus --device. _load_any and load_fused_buckets are the same
# code; the batch commands are the same code but for the device they pass.
"""Command-line interface: ``encode`` / ``decode`` / ``encode-batch`` /
``decode-batch`` subcommands.

    python -m codec_tcc_tpu_torch encode in.dcm out.stgc --message "..." [--beta ...]
    python -m codec_tcc_tpu_torch encode in.dcm out.stgc --message "..." --strategy pee
    python -m codec_tcc_tpu_torch decode out.stgc --output-prefix decoded
    python -m codec_tcc_tpu_torch encode-batch a.dcm b.dcm --output-dir out --message "..." [--fused]
    python -m codec_tcc_tpu_torch decode-batch out/*.stgc --output-dir dec

All run on ``--device cuda`` (the default, through the hand-written
kernels) or ``--device cpu`` (their plain torch versions). The JAX CLI's
other subcommands are still to be ported (ROADMAP.md, queue 1).
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

import numpy as np

from .config import STRATEGIES, EncodeConfig
from .io import dicom
from .io.codecs import available_names
from .utils.logging import get_logger, set_verbosity, write_json_report

logger = get_logger("cli")


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="codec_tcc_tpu_torch",
        description="Reversible steganography codec for DICOM images "
                    "(PyTorch/CUDA port)",
    )
    p.add_argument("-v", "--verbose", action="store_true")
    sub = p.add_subparsers(dest="command", required=True)

    enc = sub.add_parser("encode", help="embed a payload into an image")
    enc.add_argument("input", help="input DICOM file")
    enc.add_argument("output", help="output .stgc container")
    g = enc.add_mutually_exclusive_group(required=True)
    g.add_argument("--message", help="text payload")
    g.add_argument("--payload-file", help="binary payload file")
    enc.add_argument("--beta", type=float, default=0.4,
                     help="entropy retention target (reference default 0.4)")
    enc.add_argument("--strategy", choices=STRATEGIES, default="hybrid")
    enc.add_argument("--codec", default="deflate",
                     help=f"transport codec (available: {available_names()})")
    enc.add_argument("--block-size", type=int, default=8)
    enc.add_argument("--search-block-size", type=int, default=16)
    enc.add_argument("--align-across-planes", action="store_true")
    enc.add_argument("--seed", type=int, default=42)
    enc.add_argument("--nbits", type=int, default=None,
                     help="bit planes to consider (default: DICOM BitsStored)")
    enc.add_argument("--ignore-bits-stored", action="store_true",
                     help="reproduce reference defect B6 (use dtype width)")
    enc.add_argument("--pee-threshold", type=int, default=2)
    enc.add_argument("--no-bitmaps", action="store_true",
                     help="omit XOR location maps (smaller file, no restore)")
    enc.add_argument("--container-version", type=int, default=2, choices=(1, 2))
    enc.add_argument("--device-policy", choices=("auto", "device", "host"),
                     default="auto",
                     help="where the raster embed runs: 'host' places the "
                          "payload with numpy windows, 'auto' does so when "
                          "no metrics are asked for")
    enc.add_argument("--device", default="cuda",
                     help="torch device: cuda (kernels) or cpu (plain torch)")
    enc.add_argument("--report", help="write a JSON run report here")
    enc.add_argument("--profile-dir",
                     help="capture a torch.profiler trace here")

    dec = sub.add_parser("decode", help="extract payload + images from a container")
    dec.add_argument("input", help=".stgc container")
    dec.add_argument("--output-prefix", default="decoded")
    dec.add_argument("--no-restore", action="store_true",
                     help="skip original-image restoration")
    dec.add_argument("--device", default="cuda",
                     help="torch device: cuda (kernels) or cpu (plain torch)")
    dec.add_argument("--report", help="write a JSON run report here")

    benc = sub.add_parser(
        "encode-batch",
        help="encode many images with per-item checkpointing/resume (a "
             "crashed run re-processes only unfinished items)",
    )
    benc.add_argument("inputs", nargs="+", help="input image files")
    benc.add_argument("--output-dir", required=True,
                      help="one .stgc per input + manifest.json checkpoint")
    gb = benc.add_mutually_exclusive_group(required=True)
    gb.add_argument("--message", help="text payload (same for every item)")
    gb.add_argument("--payload-file", help="binary payload file")
    benc.add_argument("--beta", type=float, default=0.4)
    benc.add_argument("--strategy", choices=STRATEGIES, default="hybrid")
    benc.add_argument("--codec", default="deflate")
    benc.add_argument("--device-policy", choices=("auto", "device", "host"),
                      default="auto",
                      help="where raster embeds run (see encode)")
    benc.add_argument("--no-retry-failed", action="store_true",
                      help="on resume, skip items that failed before")
    benc.add_argument("--fused", action="store_true",
                      help="one batch launch per same-geometry input group "
                           "(mixed geometries bucket automatically; "
                           "throughput mode, no per-item resume)")
    benc.add_argument("--device", default="cuda",
                      help="torch device: cuda (kernels) or cpu (plain torch)")

    bdec = sub.add_parser(
        "decode-batch",
        help="decode many containers (homogeneous groups decode together)",
    )
    bdec.add_argument("inputs", nargs="+", help=".stgc container files")
    bdec.add_argument("--output-dir", required=True,
                      help="per-item <name>_message.txt / _original.dcm")
    bdec.add_argument("--no-restore", action="store_true",
                      help="skip original-image restoration")
    bdec.add_argument("--device", default="cuda",
                      help="torch device: cuda (kernels) or cpu (plain torch)")
    return p


def _load_any(path: str) -> np.ndarray:
    if path.lower().endswith(".dcm"):
        arr, _ = dicom.load_image(path)
        return arr
    if path.lower().endswith(".npy"):
        return np.load(path)
    from PIL import Image, UnidentifiedImageError

    try:
        arr = np.array(Image.open(path))
    except UnidentifiedImageError as exc:
        raise ValueError(f"Invalid file: unrecognized image {path}") from exc
    if arr.dtype == np.int32:
        arr = arr.astype(np.uint16)
    return arr


def cmd_encode(args: argparse.Namespace) -> int:
    from . import pipeline
    from .profiling import get_profiler, trace_to

    if args.message is not None:
        payload: object = args.message
    else:
        with open(args.payload_file, "rb") as f:
            payload = f.read()

    config = EncodeConfig(
        beta=args.beta,
        strategy=args.strategy,
        codec=args.codec,
        block_size=args.block_size,
        search_block_size=args.search_block_size,
        align_across_planes=args.align_across_planes,
        seed=args.seed,
        nbits=args.nbits,
        use_bits_stored=not args.ignore_bits_stored,
        pee_threshold=args.pee_threshold,
        store_bitmaps=not args.no_bitmaps,
        container_version=args.container_version,
        device_policy=args.device_policy,
    )
    with trace_to(args.profile_dir):
        result = pipeline.encode_dicom(
            args.input, payload, config, device=args.device
        )
    with open(args.output, "wb") as f:
        f.write(result.container)
    if args.verbose:
        get_profiler().log_report()

    print(f"cut point s          : {result.s}")
    print(f"strategy             : {result.meta.strategy}")
    print(f"codec                : {result.meta.codec}")
    print(f"payload bits         : {result.meta.payload_bits}")
    print(f"container bytes      : {len(result.container)}")
    if result.metrics:
        print(f"MSE / PSNR / SSIM    : {result.metrics['mse']:.6f} / "
              f"{result.metrics['psnr']:.2f} dB / {result.metrics['ssim']:.6f}")
        print(f"pixels changed       : {int(result.metrics['changed_pixels'])}"
              f" ({result.metrics['changed_percent']:.3f}%)")
    if args.report:
        write_json_report(args.report, {
            "command": "encode",
            "input": args.input,
            "output": args.output,
            "device": args.device,
            "s": result.s,
            "entropy": result.decomposition.entropy,
            "mi_curve": result.decomposition.mi.tolist(),
            "meta": {
                "strategy": result.meta.strategy,
                "codec": result.meta.codec,
                "payload_bits": result.meta.payload_bits,
                "container_bytes": len(result.container),
            },
            "metrics": result.metrics,
        })
    return 0


def _write_payload(payload: bytes, prefix: str) -> str:
    """Write a decoded payload as ``<prefix>_message.txt`` when it is valid
    UTF-8, else ``<prefix>_payload.bin``; returns the path written."""
    try:
        text = payload.decode("utf-8")
    except UnicodeDecodeError:
        path = f"{prefix}_payload.bin"
        with open(path, "wb") as f:
            f.write(payload)
        return path
    path = f"{prefix}_message.txt"
    with open(path, "w", encoding="utf-8") as f:
        f.write(text)
    return path


def cmd_decode(args: argparse.Namespace) -> int:
    from . import pipeline

    result = pipeline.decode_file(
        args.input, restore_original=not args.no_restore, device=args.device
    )
    prefix = args.output_prefix

    payload = result.payload
    msg_path = _write_payload(payload, prefix)

    stego_path = f"{prefix}_stego.dcm"
    dicom.save_image(result.stego, stego_path)
    print(f"payload bits         : {result.payload_bits.size}")
    print(f"payload written to   : {msg_path}")
    print(f"stego image          : {stego_path}")
    if result.original is not None:
        orig_path = f"{prefix}_original.dcm"
        dicom.save_image(result.original, orig_path)
        print(f"restored original    : {orig_path}")
    if args.report:
        write_json_report(args.report, {
            "command": "decode",
            "input": args.input,
            "device": args.device,
            "payload_bits": int(result.payload_bits.size),
            "strategy": result.meta.strategy,
            "codec": result.meta.codec,
            "restored_original": result.original is not None,
        })
    return 0


def cmd_encode_batch(args: argparse.Namespace) -> int:
    from .config import EncodeConfig
    from .parallel.runner import BatchRunner

    if args.message is not None:
        payload: object = args.message
    else:
        with open(args.payload_file, "rb") as f:
            payload = f.read()
    cfg = EncodeConfig(beta=args.beta, strategy=args.strategy,
                       codec=args.codec, device_policy=args.device_policy)
    if args.fused:
        return _encode_batch_fused(args, cfg, payload)
    runner = BatchRunner(args.output_dir, cfg, device=args.device)
    results = runner.run(args.inputs, payload,
                         retry_failed=not args.no_retry_failed)
    done = sum(1 for r in results if r.status == "done")
    failed = [r for r in results if r.status == "failed"]
    print(f"{'INPUT':<32} {'STATUS':<8} {'s':<3} {'BYTES':<9} {'PSNR':<7}")
    print("-" * 64)
    import os as _os

    for r in results:
        psnr = f"{r.psnr:.1f}" if r.psnr is not None else "-"
        print(f"{_os.path.basename(r.input):<32} {r.status:<8} "
              f"{r.s if r.s is not None else '-':<3} "
              f"{r.container_bytes if r.container_bytes else '-':<9} {psnr:<7}")
    print(f"\n{done}/{len(results)} done; manifest: {runner.manifest_path}")
    for r in failed:
        print(f"failed: {r.input}: {r.error}", file=sys.stderr)
    return 0 if not failed else 1


def load_fused_buckets(paths: List[str]):
    """Load inputs grouped by ``(geometry, dtype, BitsStored)`` for the
    batch paths; returns ``[(input_indices, images (B,H,W) stack,
    bits_stored or None)]`` in first-seen order.

    Each group satisfies the batch plan's invariants by construction: one
    geometry, one dtype, one BitsStored cap, never DICOM (capped) and
    non-DICOM (uncapped) in the same plan, so a mixed request runs one
    batch per group."""
    buckets: dict = {}
    for idx, path in enumerate(paths):
        if path.lower().endswith(".dcm"):
            arr, ds = dicom.load_image(path)
            if arr.dtype == np.int16:
                arr = arr.astype(np.uint16)
            bs = ds.bits_stored
        else:
            arr = _load_any(path)
            bs = None
        idxs, arrs = buckets.setdefault((arr.shape, arr.dtype.str, bs), ([], []))
        idxs.append(idx)
        arrs.append(arr)
    return [
        (idxs, np.stack(arrs), bs)
        for (_, _, bs), (idxs, arrs) in buckets.items()
    ]


def encode_fused_buckets(paths: List[str], payload, cfg, *,
                         device="cuda") -> List[dict]:
    """Batch encode over mixed inputs: one
    :func:`parallel.batch.encode_batch_containers` call per
    ``(geometry, dtype, BitsStored)`` group, on ``device``. Returns one
    record per input, in input order: ``{"input", "container", "s",
    "psnr"}`` (``s`` None for PEE batches, whose plan lives in
    per-container ext blocks; ``psnr`` None unless
    ``cfg.compute_metrics``)."""
    from .parallel.batch import encode_batch_containers

    records: List[Optional[dict]] = [None] * len(paths)
    for idxs, images, bs in load_fused_buckets(paths):
        res = encode_batch_containers(
            images, [payload] * len(idxs), cfg, bits_stored=bs,
            device=device,
        )
        for j, i in enumerate(idxs):
            records[i] = {
                "input": paths[i],
                "container": res.containers[j],
                "s": int(res.plan.s[j]) if res.plan is not None else None,
                "psnr": (float(res.metrics[j]["psnr"])
                         if res.metrics is not None else None),
            }
    return records


def _encode_batch_fused(args: argparse.Namespace, cfg, payload) -> int:
    """Throughput mode for encode-batch: one batch launch per
    same-geometry input group (mixed geometries bucket automatically)."""
    import os as _os

    records = encode_fused_buckets(args.inputs, payload, cfg,
                                   device=args.device)
    _os.makedirs(args.output_dir, exist_ok=True)
    print(f"{'INPUT':<32} {'s':<3} {'BYTES':<9}")
    print("-" * 48)
    for rec in records:
        out = _os.path.join(
            args.output_dir,
            _os.path.splitext(_os.path.basename(rec["input"]))[0] + ".stgc",
        )
        with open(out, "wb") as f:
            f.write(rec["container"])
        s = rec["s"] if rec["s"] is not None else "-"
        print(f"{_os.path.basename(rec['input']):<32} {s:<3} "
              f"{len(rec['container']):<9}")
    print(f"\n{len(records)} containers -> {args.output_dir} (fused)")
    return 0


def cmd_decode_batch(args: argparse.Namespace) -> int:
    import os as _os

    from .parallel.batch import decode_batch_containers

    blobs = []
    for path in args.inputs:
        with open(path, "rb") as f:
            blobs.append(f.read())
    decs = decode_batch_containers(blobs, restore_original=not args.no_restore,
                                   device=args.device)
    _os.makedirs(args.output_dir, exist_ok=True)
    for path, dec in zip(args.inputs, decs):
        stem = _os.path.splitext(_os.path.basename(path))[0]
        msg_path = _write_payload(
            dec.payload, _os.path.join(args.output_dir, stem)
        )
        if dec.original is not None:
            dicom.save_image(
                dec.original, _os.path.join(args.output_dir, f"{stem}_original.dcm")
            )
        print(f"{_os.path.basename(path)}: {dec.payload_bits.size} bits -> {msg_path}")
    print(f"{len(decs)} containers decoded -> {args.output_dir}")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    args = _build_parser().parse_args(argv)
    if args.verbose:
        set_verbosity("DEBUG")
    handler = {
        "encode": cmd_encode,
        "decode": cmd_decode,
        "encode-batch": cmd_encode_batch,
        "decode-batch": cmd_decode_batch,
    }[args.command]
    try:
        return handler(args)
    except BrokenPipeError:
        # a pipe reader went away (`... | head`): exit like a unix tool
        try:
            os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        except OSError:
            pass
        print("error: broken pipe", file=sys.stderr)
        return 1
    except (ValueError, RuntimeError, FileNotFoundError) as exc:
        # RuntimeError covers NotImplementedError (not-yet-ported requests)
        if args.verbose:
            raise
        print(f"error: {exc}", file=sys.stderr)
        return 1
