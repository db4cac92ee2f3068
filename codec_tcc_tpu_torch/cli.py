# Port of codec_tcc_tpu/cli.py: the encode and decode subcommands, with the
# same flags and output files plus --device.
"""Command-line interface: ``encode`` / ``decode`` subcommands.

    python -m codec_tcc_tpu_torch encode in.dcm out.stgc --message "..." [--beta ...]
    python -m codec_tcc_tpu_torch encode in.dcm out.stgc --message "..." --strategy pee
    python -m codec_tcc_tpu_torch decode out.stgc --output-prefix decoded

Both run on ``--device cuda`` (the default, through the hand-written
kernels) or ``--device cpu`` (their plain torch versions). The JAX CLI's
other subcommands are still to be ported (ROADMAP.md, queue 1).
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

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
    return p


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


def main(argv: Optional[List[str]] = None) -> int:
    args = _build_parser().parse_args(argv)
    if args.verbose:
        set_verbosity("DEBUG")
    handler = {"encode": cmd_encode, "decode": cmd_decode}[args.command]
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
