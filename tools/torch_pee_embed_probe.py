#!/usr/bin/env python3
"""Iterate on kernel K3 ``pee_embed`` of the PyTorch/CUDA port on one GPU,
without the whole ``chip_smoke.py``.

    python3 tools/torch_pee_embed_probe.py [--ptxas] [--sass PATH] [--check] [--time]

* ``--ptxas``: registers, shared memory and spills of every kernel in
  ``codec_tcc_tpu_torch/csrc/pee_embed.cu`` (``nvcc -Xptxas -v``).
* ``--sass PATH``: the uint16 kernel's SASS (``cuobjdump``) into PATH,
  and its instruction count by opcode.
* ``--check``: K3 against its plain version, all five outputs exact, on the
  look-back stress cases of ``tests/torch_pee_stress.py`` (K4 restores the
  image from K3's output), and the many-tile launch 20 times, identical.
* ``--time``: K3 at the 2048x2048 uint16 3 Mbit PEE plan (the
  ``pee_cr2048_u16_3m`` parity case, pass 0 and pass 1): device time per
  call from ``torch.profiler`` split by CUDA activity (kernel, memset), per
  call with CUDA events, the plain version, the bytes bound; beside it the
  same for the :data:`VARIANTS`, built from patched copies of the sources
  (a part stubbed out, whose outputs are then wrong and only timed; other
  block sizes and register limits), and a torch copy of the same bytes
  (image read, stego and overflow map written) as a yardstick of the
  achievable rate.

Prints the card's name and power limit first; fails without a GPU.
"""

from __future__ import annotations

import argparse
import os
import re
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

# name -> [(pattern, replacement), ...], each applied where it matches (once
# over csrc/pee_embed.cu and csrc/pee_common.cuh); the variants that change
# what is computed are timed only
PATCHED = ("pee_embed.cu", "pee_common.cuh")
_NO_LOOKBACK = (r"pee_lookback\(\s*status.*?\);", "0u;")
_NO_TICKET = (r"pee_take_ticket\(ticket, &s_tile\)", "(int)blockIdx.x")
_NO_MESSAGE = (r"const int n_emb = __popc\(proc & elig\);",
               "const int n_emb = 0;")
_NO_SLEEP = (r"__nanosleep\(32\);", "")


def _threads(n):
    return (r"#define PEE_EMBED_THREADS 256", f"#define PEE_EMBED_THREADS {n}")


def _min_blocks(n):
    return (r"__launch_bounds__\(PEE_EMBED_THREADS\)",
            f"__launch_bounds__(PEE_EMBED_THREADS, {n})")


VARIANTS = {
    "no look-back (prefix 0; time only)": [_NO_LOOKBACK],
    "tile from blockIdx, no ticket (time only)": [_NO_TICKET],
    "no message load (bit 0; time only)": [_NO_MESSAGE],
    "no look-back, ticket or message load (time only)":
        [_NO_LOOKBACK, _NO_TICKET, _NO_MESSAGE],
    "look-back without sleep": [_NO_SLEEP],
    "rows above and below read as the run itself (time only)":
        [(r"pee_load_vec\(im \+ p0 - w, up\);", "pee_load_vec(im + p0, up);"),
         (r"pee_load_vec\(im \+ p0 \+ w, dn\);", "pee_load_vec(im + p0, dn);")],
    "no stego or overflow store (time only)":
        [(r"pee_store_run\(stego \+ img_off, p0, n, out\);", "if (out[0] == 12345 && out[1] == 54321) stego[0] = 0;"),
         (r"pee_store_mask16\(over \+ img_off, p0, n, proc & ovfm\);", "if ((proc & ovfm) == 0xffff) over[0] = 1;")],
    "look-back fenced (threadfence before each publish)":
        [(r"(void pee_st_publish\(.*?\{)", r"\1 __threadfence();")],
    "128 threads per tile": [_threads(128)],
    "512 threads per tile": [_threads(512)],
    "256 threads, at least 5 blocks per SM": [_min_blocks(5)],
}


def ptxas() -> None:
    from codec_tcc_tpu_torch.ops import kernel_library as kl

    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run(
            [kl._nvcc(), *kl.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
             os.path.join(tmp, "k3.o"), str(kl.CSRC / "pee_embed.cu")],
            capture_output=True, text=True)
    print(proc.stderr)
    if proc.returncode:
        sys.exit("nvcc failed")


def sass(out: str) -> None:
    """SASS of the uint16 K3 kernel into ``out``, and its opcode counts."""
    import collections
    from codec_tcc_tpu_torch.ops import kernel_library as kl

    cuobjdump = os.path.join(os.path.dirname(kl._nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", str(kl.build_library())],
                          capture_output=True, text=True, check=True).stdout
    funcs = text.split("Function : ")
    body = next(f for f in funcs if f.startswith("_Z16pee_embed_kernelIt"))
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w", encoding="utf-8") as f:
        f.write(body)
    ops = collections.Counter(
        m.group(1).split(".")[0]
        for m in re.finditer(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9.]+)",
                             body))
    print(f"K3 u16 SASS: {sum(ops.values())} instructions -> {out}; "
          f"{dict(ops.most_common(30))}")


def check(dev) -> None:
    import chip_smoke

    print(chip_smoke.phase2_pee_stress(dev), flush=True)


def variant_library(name, tmp):
    """The kernel library built from csrc with VARIANTS[name] applied, in
    its own build directory."""
    from codec_tcc_tpu_torch.ops import kernel_library as kl

    src = os.path.join(tmp, f"csrc{len(os.listdir(tmp))}")
    shutil.copytree(kl.CSRC, src)
    texts = {}
    for fname in PATCHED:
        with open(os.path.join(src, fname), encoding="utf-8") as f:
            texts[fname] = f.read()
    for pattern, repl in VARIANTS[name]:
        total = 0
        for fname in PATCHED:
            texts[fname], count = re.subn(pattern, repl, texts[fname],
                                          flags=re.S)
            total += count
        if total != 1:
            sys.exit(f"variant {name!r}: {pattern!r} matched {total} times")
    for fname, text in texts.items():
        with open(os.path.join(src, fname), "w", encoding="utf-8") as f:
            f.write(text)
    saved = kl.CSRC, kl.BUILD_DIR
    kl.CSRC = kl.Path(src)
    kl.BUILD_DIR = kl.Path(src) / "build"
    try:
        return kl.library.__wrapped__()
    finally:
        kl.CSRC, kl.BUILD_DIR = saved


def profile_split(fn, reps=50):
    """Device ms per call of ``fn()`` by CUDA activity name (profiler)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    split = {}
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA:
            key = evt.key[:60]   # names that share a prefix add up
            split[key] = (split.get(key, 0.0)
                          + evt.self_device_time_total / 1e3 / reps)
    return {k: v for k, v in split.items() if v > 0}


def time_k3(dev) -> None:
    import torch
    import chip_smoke
    import torch_port_cases as cases
    from codec_tcc_tpu_torch.models.pee import message_buffer
    from codec_tcc_tpu_torch.ops import pee_kernels as pk

    case = cases.BY_NAME["pee_cr2048_u16_3m"]
    t = cases.load_parity()[case.name]["pee_ext"][0]
    img = cases.image(case)
    bits = cases.payload_bits(case, 0)
    n, max_val = img.size, (1 << case.bits_stored) - 1
    i32 = dict(dtype=torch.int32, device=dev)
    img_d = torch.from_numpy(img).to(dev)[None]
    msg_d = message_buffer([bits], dev)
    want = torch.tensor([bits.size], **i32)
    zero = torch.zeros(1, **i32)
    s0, _, u0, _, _ = pk.pee_embed(img_d, msg_d, zero, want, 0, t, max_val)
    passes = {"pass 0": (img_d, zero, want, 0),
              "pass 1": (s0, u0, want - u0, 1)}
    used = {"pass 0": int(u0), "pass 1": bits.size - int(u0)}

    def row(label, fn, nbytes=None):
        split = profile_split(fn)
        dev_ms = sum(split.values())
        ms = chip_smoke.cuda_median_ms(fn)
        bound = ("" if nbytes is None else
                 f", bound {chip_smoke.bound(nbytes, 20 * n)[0]:.4f} ms "
                 f"({nbytes} B)")
        print(f"  {label}: device {dev_ms:.4f} ms "
              f"{ {k: round(v, 4) for k, v in split.items()} }, per call "
              f"{ms:.4f} ms{bound}", flush=True)

    print(f"2048x2048 u16 T={t}, {bits.size} bits", flush=True)
    for key, (im, base, wv, parity) in passes.items():
        nbytes = 2 * n + 2 * n + n + used[key]
        row(f"K3 {key}", lambda: pk.pee_embed(im, msg_d, base, wv, parity, t,
                                               max_val), nbytes)
        row(f"plain {key}", lambda: pk.pee_embed_plain(
            im, msg_d, base, wv, parity, t, max_val))
    stego = torch.empty_like(img_d)
    over = torch.empty(img_d.shape, dtype=torch.uint8, device=dev)
    row("torch copy of the bytes (image -> stego, zero overflow map)",
        lambda: (stego.copy_(img_d), over.zero_()), 5 * n)

    real = pk.library
    with tempfile.TemporaryDirectory() as tmp:
        for name in VARIANTS:
            lib = variant_library(name, tmp)
            pk.library = lambda lib=lib: lib
            try:
                for key, (im, base, wv, parity) in passes.items():
                    row(f"K3 {key}, {name}",
                        lambda: pk.pee_embed(im, msg_d, base, wv, parity, t,
                                             max_val))
            finally:
                pk.library = real


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--sass", metavar="PATH")
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--time", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA GPU: this probe runs K3 on the card")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    dev = torch.device("cuda")
    if args.ptxas:
        ptxas()
    if args.sass:
        sass(args.sass)
    if args.check:
        check(dev)
    if args.time:
        time_k3(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
