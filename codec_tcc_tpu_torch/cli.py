# Port of codec_tcc_tpu/cli.py: every subcommand, with the same flags,
# output lines, files and exit codes plus --device. `doctor` reports torch
# and the requested device where the JAX CLI reports jax and its platform
# gates; its device probe child runs torch (and loads the kernel library on
# CUDA), and its codec loop reports a codec that `get` refuses as
# unavailable instead of stopping. _load_any, load_fused_buckets and
# _load_volume are the same code; the batch, volume, capacity, analyze and
# demo commands are the same code but for the device they pass. demo takes its --input
# explicitly (the JAX CLI defaults it to the reference's bundled DICOM).
"""Command-line interface.

    python -m codec_tcc_tpu_torch encode in.dcm out.stgc --message "..." [--beta ...]
    python -m codec_tcc_tpu_torch encode in.dcm out.stgc --message "..." --strategy pee
    python -m codec_tcc_tpu_torch decode out.stgc --output-prefix decoded
    python -m codec_tcc_tpu_torch analyze original.dcm stego.dcm [--windowed-ssim]
    python -m codec_tcc_tpu_torch capacity in.dcm [--json]
    python -m codec_tcc_tpu_torch encode-volume vol.npy --output v.stgv --message "..."
    python -m codec_tcc_tpu_torch decode-volume v.stgv --output-prefix vol [--dicom]
    python -m codec_tcc_tpu_torch encode-batch a.dcm b.dcm --output-dir out --message "..." [--fused]
    python -m codec_tcc_tpu_torch decode-batch out/*.stgc --output-dir dec

    python -m codec_tcc_tpu_torch serve --socket ct.sock [--warmup 512x512]
    python -m codec_tcc_tpu_torch doctor [--json] [--no-device]

All run on ``--device cuda`` (the default, through the hand-written
kernels) or ``--device cpu`` (their plain torch versions).
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

    ana = sub.add_parser("analyze", help="quality metrics between two images")
    ana.add_argument("original")
    ana.add_argument("stego")
    ana.add_argument("--windowed-ssim", action="store_true",
                     help="also compute mean windowed SSIM")
    ana.add_argument("--bits-stored-range", action="store_true",
                     help="use BitsStored-derived value ranges for DICOM "
                          "inputs (the reference mse.py CLI's policy) "
                          "instead of the data maxima")
    ana.add_argument("--device", default="cuda",
                     help="torch device: cuda or cpu")
    ana.add_argument("--report", help="write a JSON run report here")

    anb = sub.add_parser(
        "analyze-batch",
        help="quality metrics for many (original, stego) pairs "
             "(the reference's analisar_multiplos_pares, mse.py:265-295)",
    )
    anb.add_argument(
        "pairs", nargs="+",
        help="original1 stego1 [original2 stego2 ...] (alternating paths)",
    )
    anb.add_argument("--windowed-ssim", action="store_true")
    anb.add_argument("--device", default="cuda",
                     help="torch device: cuda or cpu")
    anb.add_argument("--report", help="write the aggregate JSON report here")

    cap = sub.add_parser(
        "capacity",
        help="usable payload capacity of an image (or volume) per strategy, "
             "before encoding anything",
    )
    cap.add_argument("input", help="DICOM / PNG / .npy image or volume")
    cap.add_argument("--beta", type=float, default=0.4,
                     help="entropy retention target (reference default 0.4)")
    cap.add_argument("--seed", type=int, default=42)
    cap.add_argument("--nbits", type=int, default=None,
                     help="bit planes to consider (default: DICOM BitsStored)")
    cap.add_argument("--ignore-bits-stored", action="store_true")
    cap.add_argument("--pee-threshold", type=int, default=2)
    cap.add_argument("--device", default="cuda",
                     help="torch device: cuda (kernels) or cpu (plain torch)")
    cap.add_argument("--json", action="store_true",
                     help="machine-readable output")

    demo = sub.add_parser(
        "demo",
        help="encode-then-decode self check (the reference's main() demo, "
             "src/codec.py:847-926, which here round-trips)",
    )
    demo.add_argument("--input", required=True, help="input DICOM file")
    demo.add_argument("--output-dir", default="output")
    demo.add_argument("--codec", default="deflate")
    demo.add_argument("--device", default="cuda",
                      help="torch device: cuda (kernels) or cpu (plain torch)")

    venc = sub.add_parser(
        "encode-volume",
        help="embed one payload across a volume (STGV container: one global "
             "cut point, capacity-aware per-slice split, per-slice recovery)",
    )
    venc.add_argument(
        "inputs", nargs="+",
        help="one 3-D .npy volume, or 2-D slice files (DICOM/PNG) in order",
    )
    venc.add_argument("--output", required=True, help="output .stgv file")
    gv = venc.add_mutually_exclusive_group(required=True)
    gv.add_argument("--message", help="text payload")
    gv.add_argument("--payload-file", help="binary payload file")
    venc.add_argument("--beta", type=float, default=0.4)
    venc.add_argument("--codec", default="deflate",
                      help=f"transport codec (available: {available_names()})")
    venc.add_argument("--seed", type=int, default=42)
    venc.add_argument("--strategy", default="multi_plane",
                      choices=["multi_plane", "hybrid", "block_adaptive",
                               "pee"],
                      help="multi_plane/hybrid/block_adaptive: global cut "
                           "point + per-slice LSB placement (raster 0 / "
                           "variance-chosen start / variance-ranked tiles); "
                           "pee: per-slice-threshold prediction-error "
                           "expansion")
    venc.add_argument("--device", default="cuda",
                      help="torch device: cuda (kernels) or cpu (plain torch)")
    venc.add_argument("--report", help="write a JSON run report here")

    vdec = sub.add_parser(
        "decode-volume", help="extract payload + volumes from an STGV file"
    )
    vdec.add_argument("input", help=".stgv file")
    vdec.add_argument("--output-prefix", default="volume")
    vdec.add_argument("--dicom", action="store_true",
                      help="also write stego/restored volumes as multiframe "
                           "DICOM files (<prefix>_stego.dcm / _original.dcm)")
    vdec.add_argument("--device", default="cuda",
                      help="torch device: cuda (kernels) or cpu (plain torch)")

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

    srv = sub.add_parser(
        "serve",
        help="warm serving daemon: JSON-lines over a Unix socket (pays the "
             "first device contact and the kernel library's load once, then "
             "serves requests warm; one daemon per card)",
    )
    srv.add_argument("--socket", required=True, help="Unix socket path")
    srv.add_argument("--warmup", default=None, metavar="HxW[,HxW...]",
                     help="encode+decode a synthetic image per geometry at "
                          "startup (e.g. 512x512,640x480) so the first "
                          "request of each size is warm")
    srv.add_argument("--idle-timeout", type=float, default=None,
                     help="exit after this many seconds with no connection")
    srv.add_argument("--conn-timeout", type=float, default=600.0,
                     help="drop a connection silent for this many seconds "
                          "(it blocks all other clients while open)")
    srv.add_argument("--device", default="cuda",
                     help="torch device every request runs on: cuda "
                          "(kernels) or cpu (plain torch)")

    doc = sub.add_parser(
        "doctor",
        help="environment health check: device reachability and the kernel "
             "library's build (in a bounded subprocess), codec round-trips, "
             "native shims, competing processes",
    )
    doc.add_argument("--json", action="store_true", help="machine-readable")
    doc.add_argument("--no-device", action="store_true",
                     help="skip the device probe (host-only checks)")
    doc.add_argument("--device-timeout", type=float, default=180.0,
                     help="seconds before declaring the device unreachable "
                          "(the first CUDA contact builds the kernels)")
    doc.add_argument("--device", default="cuda",
                     help="torch device to probe: cuda (also builds and "
                          "loads the kernel library) or cpu")
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
    from .profiling import enable, get_profiler, trace_to

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
    if args.verbose:
        enable()
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


def cmd_capacity(args: argparse.Namespace) -> int:
    """Usable payload capacity per strategy (see pipeline.capacity_report)."""
    import json as json_mod

    from . import pipeline

    arr, bits_stored = pipeline.load_input(args.input)
    out = {"input": args.input}
    out.update(pipeline.capacity_report(
        arr, bits_stored=bits_stored, beta=args.beta, seed=args.seed,
        nbits=args.nbits, use_bits_stored=not args.ignore_bits_stored,
        pee_threshold=args.pee_threshold, device=args.device,
    ))

    if args.json:
        print(json_mod.dumps(out))
        return 0
    geom = "x".join(str(v) for v in arr.shape)
    bs = f" (BitsStored {bits_stored})" if bits_stored else ""
    print(f"image                : {args.input}  {geom} {arr.dtype}{bs}")
    print(f"cut point s          : {out['cut_point_s']} "
          f"(beta={args.beta}, nbits={out['nbits']})")
    print("usable payload capacity:")
    print(f"  multi_plane/hybrid/block_adaptive : {out['lsb_bits']} bits "
          f"({out['lsb_bits'] // 8} bytes)")
    print(f"  pee (two-pass, T={out['pee_threshold']})               : "
          f"{out['pee_bits']} bits ({out['pee_bits'] // 8} bytes)")
    print(f"  [reference s*H*W rule claims {out['reference_rule_bits']} "
          f"bits but oversubscribes plane 0]")
    return 0


def cmd_analyze(args: argparse.Namespace) -> int:
    from . import pipeline

    if args.bits_stored_range:
        # the reference mse.py CLI derives ranges from carregar_imagem's
        # BitsStored for DICOM inputs (src/mse.py:18-37)
        from .analyze import load_image

        orig, max_o, _ = load_image(args.original)
        stego, max_s, _ = load_image(args.stego)
        if orig.shape != stego.shape:
            raise ValueError(f"Shape mismatch: {orig.shape} vs {stego.shape}")
        rep = pipeline.analyze_pair(orig, stego, range_a=max_o, range_b=max_s,
                                    device=args.device)
        ssim_range = max(float(max_o), float(max_s))
    else:
        # multiframe DICOM pairs analyze as FULL volumes here (all frames in
        # one reduction); the --bits-stored-range branch keeps the reference
        # mse.py's first-frame-only behavior (src/mse.py:18-37)
        orig = _load_any(args.original)
        stego = _load_any(args.stego)
        if orig.shape != stego.shape:
            raise ValueError(f"Shape mismatch: {orig.shape} vs {stego.shape}")
        rep = pipeline.analyze_pair(orig, stego, device=args.device)
        ssim_range = max(float(orig.max()), float(stego.max()))
    if args.windowed_ssim:
        from .ops.metrics import ssim_windowed

        if orig.ndim != 2:
            raise ValueError(
                "--windowed-ssim is 2-D only; analyze frames individually"
            )
        rep["ssim_windowed"] = float(ssim_windowed(orig, stego, ssim_range,
                                                   device=args.device))
        print(f"SSIM (windowed)      : {rep['ssim_windowed']:.6f}")
    print(f"MSE                  : {rep['mse']:.6f}")
    print(f"PSNR                 : {rep['psnr']:.2f} dB")
    print(f"SSIM (global)        : {rep['ssim']:.6f}")
    print(f"mean abs diff        : {rep['mean_abs_diff']:.4f}")
    print(f"max abs diff         : {rep['max_abs_diff']:.0f}")
    print(f"pixels changed       : {int(rep['changed_pixels'])}"
          f" ({rep['changed_percent']:.3f}%)")
    from .analyze import _verdicts

    quality, structure = _verdicts(rep)
    print(f"verdict              : {quality}; {structure}")
    if args.report:
        write_json_report(args.report, {"command": "analyze", **rep})
    return 0


def cmd_analyze_batch(args: argparse.Namespace) -> int:
    import os

    from .analyze import QualityAnalyzer

    if len(args.pairs) % 2:
        print("error: pairs must alternate original stego paths", file=sys.stderr)
        return 2
    analyzer = QualityAnalyzer(windowed_ssim=args.windowed_ssim,
                               device=args.device)
    triples = [
        (args.pairs[i], args.pairs[i + 1],
         os.path.splitext(os.path.basename(args.pairs[i]))[0])
        for i in range(0, len(args.pairs), 2)
    ]
    results = analyzer.analyze_pairs(triples)
    print(f"{'NAME':<20} {'MSE':<12} {'PSNR':<10} {'SSIM':<10} {'CHANGED%':<9}")
    print("-" * 64)
    for r in results:
        m = r.metrics
        psnr = f"{m['psnr']:.2f}" if m["psnr"] != float("inf") else "inf"
        print(f"{r.name:<20} {m['mse']:<12.6f} {psnr:<10} "
              f"{m['ssim']:<10.6f} {m['changed_percent']:<9.3f}")
    if results:
        s = analyzer.summary()
        print(f"\nmean MSE {s['mse_mean']:.6f}  "
              f"mean PSNR {s.get('psnr_mean', float('inf')):.2f} dB  "
              f"mean SSIM {s['ssim_mean']:.6f}  ({int(s['count'])} pairs)")
    if args.report:
        analyzer.report(args.report)
    return 0 if results else 1


def cmd_demo(args: argparse.Namespace) -> int:
    """The reference demo flow (beta=0.4, hybrid embed with 16px search
    blocks, the same example message) followed by an immediate decode and
    verification, which the reference's own demo never passed (defect B1)."""
    import os

    from . import pipeline
    from .config import EncodeConfig

    os.makedirs(args.output_dir, exist_ok=True)
    message = "Mensagem de teste para esteganografia!"
    cfg = EncodeConfig(beta=0.4, strategy="hybrid", search_block_size=16,
                       codec=args.codec)
    res = pipeline.encode_dicom(args.input, message, cfg, device=args.device)
    out_bin = os.path.join(args.output_dir, "example.stgc")
    with open(out_bin, "wb") as f:
        f.write(res.container)
    print(f"encoded {args.input} -> {out_bin} "
          f"(s={res.s}, {len(res.container)} bytes)")

    dec = pipeline.decode_file(out_bin, device=args.device)
    ok_msg = dec.message == message
    orig, _ = dicom.load_image(args.input)
    ok_img = dec.original is not None and bool(np.array_equal(dec.original, orig))
    print(f"decoded message      : {dec.message!r}")
    print(f"message round-trip   : {'OK' if ok_msg else 'FAILED'}")
    print(f"original restored    : {'OK' if ok_img else 'FAILED'}")
    dicom.save_image(dec.stego, os.path.join(args.output_dir, "decoded_stego.dcm"))
    return 0 if (ok_msg and ok_img) else 1


def _load_volume(paths: List[str]) -> np.ndarray:
    if len(paths) == 1 and paths[0].lower().endswith(".npy"):
        vol = np.load(paths[0])
        if vol.ndim != 3:
            raise ValueError(f"expected a 3-D volume, got shape {vol.shape}")
        return vol
    slices = [_load_any(p) for p in paths]
    if len(slices) == 1 and slices[0].ndim == 3:
        return slices[0]          # one multiframe DICOM IS the volume
    for p, s in zip(paths, slices):
        if s.ndim != 2:
            raise ValueError(
                f"{p} is a {s.ndim}-D image; mix of multiframe and "
                f"single-frame inputs is not supported"
            )
    shapes = {s.shape for s in slices}
    if len(shapes) != 1:
        raise ValueError(f"slice shapes differ: {sorted(shapes)}")
    return np.stack(slices)


def cmd_encode_volume(args: argparse.Namespace) -> int:
    from .config import EncodeConfig
    from .parallel import volume as volume_par

    if args.message is not None:
        payload: object = args.message
    else:
        with open(args.payload_file, "rb") as f:
            payload = f.read()
    vol = _load_volume(args.inputs)
    cfg = EncodeConfig(beta=args.beta, codec=args.codec, seed=args.seed,
                       strategy=args.strategy)
    result = volume_par.encode_volume(vol, payload, cfg, device=args.device)
    blob = volume_par.pack_volume(vol, result, cfg, device=args.device)
    with open(args.output, "wb") as f:
        f.write(blob)
    print(f"volume               : {vol.shape[0]} x {vol.shape[1]}x{vol.shape[2]}")
    if result.threshold is not None:
        print(f"PEE threshold T      : {result.threshold}")
    else:
        print(f"global cut point s   : {result.s}")
    print(f"payload bits         : {int(result.slice_bits.sum())}")
    print(f"container bytes      : {len(blob)}")
    if result.metrics:
        print(f"PSNR (volume)        : {result.metrics['psnr']:.2f} dB")
    if args.report:
        write_json_report(args.report, {
            "command": "encode-volume", "output": args.output,
            "slices": int(vol.shape[0]), "s": result.s,
            "strategy": args.strategy, "pee_threshold": result.threshold,
            "payload_bits": int(result.slice_bits.sum()),
            "container_bytes": len(blob), "metrics": result.metrics,
        })
    return 0


def cmd_decode_volume(args: argparse.Namespace) -> int:
    from .parallel import volume as volume_par
    from .utils import bits as bit_utils

    with open(args.input, "rb") as f:
        data = f.read()
    payload_bits, stego, original = volume_par.unpack_volume(
        data, device=args.device)
    payload = bit_utils.bits_to_bytes(payload_bits)
    with open(f"{args.output_prefix}_payload.bin", "wb") as f:
        f.write(payload)
    np.save(f"{args.output_prefix}_stego.npy", stego)
    print(f"payload bits         : {payload_bits.size}")
    print(f"payload written to   : {args.output_prefix}_payload.bin")
    print(f"stego volume         : {args.output_prefix}_stego.npy {stego.shape}")
    if original is not None:
        np.save(f"{args.output_prefix}_original.npy", original)
        print(f"restored original    : {args.output_prefix}_original.npy")
    if args.dicom:
        dicom.save_image(stego, f"{args.output_prefix}_stego.dcm")
        print(f"stego DICOM          : {args.output_prefix}_stego.dcm")
        if original is not None:
            dicom.save_image(original, f"{args.output_prefix}_original.dcm")
            print(f"original DICOM       : {args.output_prefix}_original.dcm")
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


# The device probe of `doctor`, run in a child process with a deadline: it
# imports torch only, and on CUDA loads the kernel library (the nvcc build
# is the port's first device contact that can fail). argv: device, the
# directory that holds the package.
_DEVICE_PROBE = (
    "import sys\n"
    "import torch\n"
    "dev = torch.device(sys.argv[1])\n"
    "print('BACKEND', dev.type)\n"
    "print('DEVICES', torch.cuda.device_count() if dev.type == 'cuda' else 1)\n"
    "total = float(torch.ones(64, 64, device=dev).sum())\n"
    "if dev.type == 'cuda':\n"
    "    sys.path.insert(0, sys.argv[2])\n"
    "    from codec_tcc_tpu_torch.ops import kernel_library\n"
    "    kernel_library.library()\n"
    "print('SUM', total)\n"
)


def cmd_doctor(args: argparse.Namespace) -> int:
    """Health report for the runtime environment.

    Everything a measurement needs before it is trusted: which device
    requests will land on, whether it answers (probed in a SUBPROCESS with a
    deadline, which on CUDA also builds and loads the kernel library),
    whether every transport codec round-trips on this host, and what else
    is running (the card and the host's cores are shared resources)."""
    import json as json_mod
    import platform
    import subprocess
    import time

    import torch

    from .io import codecs as codecs_mod
    from .io import jxl_binding
    from .utils.env import probe_contention

    report: dict = {
        "python": platform.python_version(),
        "torch": torch.__version__,
        "numpy": np.__version__,
        "requested_device": args.device,
        "host_cores": os.cpu_count(),
    }

    rng = np.random.default_rng(0)
    img = rng.integers(0, 4096, size=(16, 16)).astype(np.uint16)
    codec_status = {}
    for name in codecs_mod.names():
        try:
            codec = codecs_mod.get(name)
        except (ValueError, RuntimeError):
            # RuntimeError: registered but unavailable on this host (png and
            # j2k without Pillow); the JAX package's loop stops there
            codec_status[name] = "unavailable"
            continue
        try:
            ok = np.array_equal(codec.decode(codec.encode(img)), img)
            codec_status[name] = "ok" if ok else "ROUND-TRIP MISMATCH"
        except Exception as exc:
            codec_status[name] = f"error: {str(exc)[:120]}"
    report["codecs"] = codec_status
    report["jxl_in_process"] = jxl_binding.available()
    report["competing_python"] = probe_contention()

    if not args.no_device:
        package_dir = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        t0 = time.perf_counter()
        try:
            r = subprocess.run(
                [sys.executable, "-c", _DEVICE_PROBE, args.device,
                 package_dir],
                capture_output=True, text=True, timeout=args.device_timeout,
            )
            wall = round(time.perf_counter() - t0, 1)
            vals = dict(
                ln.split(None, 1) for ln in r.stdout.splitlines()
                if ln.startswith(("BACKEND", "DEVICES", "SUM"))
            )
            if r.returncode == 0 and vals.get("SUM") == "4096.0":
                report["device"] = {
                    "ok": True,
                    "backend": vals.get("BACKEND"),
                    "device_count": int(vals.get("DEVICES", "0")),
                    "first_contact_s": wall,
                }
            else:
                report["device"] = {
                    "ok": False,
                    "error": (r.stderr.strip().splitlines() or ["no output"])[-1][:200],
                }
        except subprocess.TimeoutExpired:
            report["device"] = {
                "ok": False,
                "error": f"no answer in {args.device_timeout:.0f}s — device "
                         "unreachable or the kernel build hung",
            }

    if args.json:
        print(json_mod.dumps(report))
        return 0 if report.get("device", {}).get("ok", True) else 1

    print(f"python / torch / numpy : {report['python']} / {report['torch']} / "
          f"{report['numpy']}")
    print(f"requested device     : {report['requested_device']}")
    print(f"host cores           : {report['host_cores']}")
    print("transport codecs     : "
          + ", ".join(f"{k}={v}" for k, v in report["codecs"].items()))
    print(f"jxl in-process shim  : "
          f"{'available' if report['jxl_in_process'] else 'no (PATH fallback)'}")
    comp = report["competing_python"]
    print(f"competing python     : {len(comp)}"
          + ("" if not comp else "\n  " + "\n  ".join(comp)))
    dev = report.get("device")
    if dev is None:
        print("device               : skipped (--no-device)")
    elif dev["ok"]:
        print(f"device               : OK — backend={dev['backend']} "
              f"devices={dev['device_count']} "
              f"first contact {dev['first_contact_s']}s")
    else:
        print(f"device               : FAIL — {dev['error']}")
        return 1
    return 0


def cmd_serve(args: argparse.Namespace) -> int:
    from .serve import serve

    return serve(args.socket, warmup=args.warmup,
                 idle_timeout=args.idle_timeout,
                 conn_timeout=args.conn_timeout, device=args.device)


def main(argv: Optional[List[str]] = None) -> int:
    args = _build_parser().parse_args(argv)
    if args.verbose:
        set_verbosity("DEBUG")
    handler = {
        "encode": cmd_encode,
        "decode": cmd_decode,
        "analyze": cmd_analyze,
        "analyze-batch": cmd_analyze_batch,
        "capacity": cmd_capacity,
        "demo": cmd_demo,
        "encode-volume": cmd_encode_volume,
        "decode-volume": cmd_decode_volume,
        "encode-batch": cmd_encode_batch,
        "decode-batch": cmd_decode_batch,
        "serve": cmd_serve,
        "doctor": cmd_doctor,
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
