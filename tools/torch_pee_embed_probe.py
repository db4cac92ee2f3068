#!/usr/bin/env python3
"""Iterate on the PEE kernels of the PyTorch/CUDA port on one GPU, K3
``pee_embed`` or K4 ``pee_extract``, without the whole ``chip_smoke.py``.

    python3 tools/torch_pee_embed_probe.py [--kernel embed|extract] [--ptxas] [--sass PATH] [--check] [--time]

* ``--kernel``: the kernel the other options look at (default ``embed``,
  K3; ``extract`` is K4).
* ``--ptxas``: registers, shared memory and spills of every kernel in its
  source, ``codec_tcc_tpu_torch/csrc/pee_embed.cu`` or ``pee_extract.cu``
  (``nvcc -Xptxas -v``).
* ``--sass PATH``: the uint16 kernel's SASS (``cuobjdump``) into PATH,
  and its instruction count by opcode.
* ``--check``: the look-back stress cases of ``tests/torch_pee_stress.py``
  (``chip_smoke.py`` phase 2, both kernels): K3 against its plain version
  with K4 inverting each output, K4 at ``out_len`` and ``nproc`` at its
  tile boundaries and on forged inputs, all outputs exact, and the
  many-tile launch of each 20 times, identical.
* ``--time``: the kernel at the 2048x2048 uint16 3 Mbit PEE plan (the
  ``pee_cr2048_u16_3m`` parity case; K3 pass 0 and pass 1, K4 pass 1 and
  pass 0 as the decoder runs them): device time per call from
  ``torch.profiler`` split by CUDA activity (kernel, memset), per call
  with CUDA events, the plain version, the bytes bound; beside it the same
  for the kernel's variants (:data:`VARIANTS`), built from patched copies
  of the sources (a part stubbed out, whose outputs are then wrong and
  only timed; another design of one part; other block sizes and register
  limits), and a torch copy of the same bytes as a yardstick of the
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

# kernel -> its source and the mangled name of its uint16 instantiation
SOURCES = {"embed": ("pee_embed.cu", "_Z16pee_embed_kernelIt"),
           "extract": ("pee_extract.cu", "_Z18pee_extract_kernelIt")}
_NO_SLEEP = (r"__nanosleep\(32\);", "")
_NO_TICKET = (r"pee_take_ticket\(ticket, &s_tile\)", "(int)blockIdx.x")
_NO_LOOKBACK = (r"pee_lookback\(\s*status.*?\);", "0u;")
# K4: the tiles' bits to disjoint places without the look-back (prefix 0
# would make every tile store to the same bytes, which the card serialises)
_K4_NO_LOOKBACK = (r"pee_lookback\(\s*status.*?\);", "(unsigned)(tile * agg);")
_K4_NO_BITS = (r"\*reinterpret_cast<uint4\*>\(seg \+ lo\) =",
               "if (s_bits[lo] == 7) *reinterpret_cast<uint4*>(seg) =")


def _threads(n):
    return (r"#define PEE_THREADS 256", f"#define PEE_THREADS {n}")


def _min_blocks(kernel, n):
    """The kernel's launch bounds with at least n blocks per SM (none: no
    register cap)."""
    return (rf"__launch_bounds__\(PEE_THREADS(?:, \d+)?\)(\s*pee_{kernel}_kernel)",
            rf"__launch_bounds__(PEE_THREADS{'' if n is None else f', {n}'})\1")



# kernel -> variant name -> [(pattern, replacement), ...], each applied
# where it matches (once over the kernel's source and csrc/pee_common.cuh);
# the variants that change what is computed are timed only
VARIANTS = {
    "embed": {
        "no look-back (prefix 0; time only)": [_NO_LOOKBACK],
        "tile from blockIdx, no ticket (time only)": [_NO_TICKET],
        "no message load (bit 0; time only)":
            [(r"const int n_emb = __popc\(proc & elig\);",
              "const int n_emb = 0;")],
        "no look-back, ticket or message load (time only)":
            [_NO_LOOKBACK, _NO_TICKET,
             (r"const int n_emb = __popc\(proc & elig\);",
              "const int n_emb = 0;")],
        "look-back without sleep": [_NO_SLEEP],
        "rows above and below read as the run itself (time only)":
            [(r"pee_load_vec\(im \+ p0 - w, up\);",
              "pee_load_vec(im + p0, up);"),
             (r"pee_load_vec\(im \+ p0 \+ w, dn\);",
              "pee_load_vec(im + p0, dn);")],
        "no stego or overflow store (time only)":
            [(r"pee_store_run\(stego \+ img_off, p0, n, out\);",
              "if (out[0] == 12345 && out[1] == 54321) stego[0] = 0;"),
             (r"pee_store_mask16\(over \+ img_off, p0, n, proc & ovfm\);",
              "if ((proc & ovfm) == 0xffff) over[0] = 1;")],
        "look-back fenced (threadfence before each publish)":
            [(r"(void pee_st_publish\(.*?\{)", r"\1 __threadfence();")],
        "128 threads per tile": [_threads(128)],
        "512 threads per tile": [_threads(512)],
        "256 threads, at least 5 blocks per SM": [_min_blocks("embed", 5)],
    },
    "extract": {
        "no look-back (prefix tile * agg; time only)": [_K4_NO_LOOKBACK],
        "tile from blockIdx, no ticket (time only)": [_NO_TICKET],
        "no bit stores (time only)": [_K4_NO_BITS],
        "no look-back, ticket or bit stores (time only)":
            [_K4_NO_LOOKBACK, _NO_TICKET, _K4_NO_BITS],
        "no restored store (time only)":
            [(r"if \(live\) pee_store_run\(out_im, p0, n, out\);",
              "if (live && out[0] == 12345 && out[1] == 54321) "
              "out_im[0] = 0;")],
        "no overflow-map load (time only)":
            [(r"if \(live\) ovm = pee_load_nonzero16\(over \+ img_off, p0, "
              r"n\);", "")],
        "rows above and below read as the run itself (time only)":
            [(r"pee_load_vec\(im \+ p0 - w, up\);",
              "pee_load_vec(im + p0, up);"),
             (r"pee_load_vec\(im \+ p0 \+ w, dn\);",
              "pee_load_vec(im + p0, dn);")],
        "restore stored after the look-back":
            [(r"if \(live\) pee_store_run\(out_im, p0, n, out\);", ""),
             (r"const int prefix = s_prefix;",
              "const int prefix = s_prefix;\n"
              "    if (live) pee_store_run(out_im, p0, n, out);")],
        "bits stored by each thread at its ranks (no staging)":
            [(r"const int shift = .*?seg\[k\] = s_bits\[k\];\s*\}\s*\}\s*\}\n",
              "unsigned rest = expd;\n"
              "    for (long long r = (long long)prefix + thread_excl; rest;"
              " ++r, rest &= rest - 1) {\n"
              "        if (r < out_len) row[r] = (uint8_t)((bitm >> "
              "(__ffs(rest) - 1)) & 1u);\n    }\n")],
        "every tile takes the full path (no copy shortcut)":
            [(r"if \(pee_set_count_before\(ty, tile0 - ty \* w, h, w, "
              r"parity\) >= np\)", "if (false)")],
        "look-back without sleep": [_NO_SLEEP],
        "128 threads per tile": [_threads(128)],
        "512 threads per tile": [_threads(512)],
        "256 threads, no register cap (3 blocks per SM)":
            [_min_blocks("extract", None)],
        "256 threads, at least 5 blocks per SM": [_min_blocks("extract", 5)],
    },
}


def ptxas(kernel: str) -> None:
    from codec_tcc_tpu_torch.ops import kernel_library as kl

    src = SOURCES[kernel][0]
    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run(
            [kl._nvcc(), *kl.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
             os.path.join(tmp, "k.o"), str(kl.CSRC / src)],
            capture_output=True, text=True)
    print(proc.stderr)
    if proc.returncode:
        sys.exit("nvcc failed")


def sass(kernel: str, out: str) -> None:
    """SASS of the kernel's uint16 instantiation into ``out``, and its
    opcode counts."""
    import collections
    from codec_tcc_tpu_torch.ops import kernel_library as kl

    cuobjdump = os.path.join(os.path.dirname(kl._nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", str(kl.build_library())],
                          capture_output=True, text=True, check=True).stdout
    funcs = text.split("Function : ")
    body = next(f for f in funcs if f.startswith(SOURCES[kernel][1]))
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w", encoding="utf-8") as f:
        f.write(body)
    ops = collections.Counter(
        m.group(1).split(".")[0]
        for m in re.finditer(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9.]+)",
                             body))
    print(f"{kernel} u16 SASS: {sum(ops.values())} instructions -> {out}; "
          f"{dict(ops.most_common(30))}")


def check(dev) -> None:
    import chip_smoke

    print(chip_smoke.phase2_pee_stress(dev), flush=True)


def variant_library(kernel, name, tmp):
    """The kernel library built from csrc with VARIANTS[kernel][name]
    applied, in its own build directory."""
    from codec_tcc_tpu_torch.ops import kernel_library as kl

    src = os.path.join(tmp, f"csrc{len(os.listdir(tmp))}")
    shutil.copytree(kl.CSRC, src)
    texts = {}
    for fname in (SOURCES[kernel][0], "pee_common.cuh"):
        with open(os.path.join(src, fname), encoding="utf-8") as f:
            texts[fname] = f.read()
    for pattern, repl in VARIANTS[kernel][name]:
        total = 0
        for fname in texts:
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


def row(label, fn, n, nbytes=None):
    """Prints one timed line: device time split by activity, per call."""
    import chip_smoke

    split = profile_split(fn)
    dev_ms = sum(split.values())
    ms = chip_smoke.cuda_median_ms(fn)
    bound = ("" if nbytes is None else
             f", bound {chip_smoke.bound(nbytes, 20 * n)[0]:.4f} ms "
             f"({nbytes} B)")
    print(f"  {label}: device {dev_ms:.4f} ms "
          f"{ {k: round(v, 4) for k, v in split.items()} }, per call "
          f"{ms:.4f} ms{bound}", flush=True)


def plan(dev):
    """The 3 Mbit 2048x2048 uint16 plan: image, message, T and the calls of
    both passes of each kernel as (label, kernel call, plain call, bytes
    the function must move)."""
    import torch
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
    s0, o0, u0, n0, _ = pk.pee_embed(img_d, msg_d, zero, want, 0, t, max_val)
    s1, o1, u1, n1, _ = pk.pee_embed(s0, msg_d, u0, want - u0, 1, t, max_val)
    over = o0 | o1
    out_len = 1 << max(3, (bits.size - 1).bit_length())
    r1 = pk.pee_extract(s1, over, n1, 1, t, out_len)[0]
    embed = [(f"pass {p}",
              (lambda im=im, base=base, wv=wv, p=p:
               pk.pee_embed(im, msg_d, base, wv, p, t, max_val)),
              (lambda im=im, base=base, wv=wv, p=p:
               pk.pee_embed_plain(im, msg_d, base, wv, p, t, max_val)),
              2 * n + 2 * n + n + int(used))
             for p, im, base, wv, used in ((0, img_d, zero, want, u0),
                                           (1, s0, u0, want - u0, u1))]
    extract = [(f"pass {p}",
                (lambda st=st, np_=np_, p=p:
                 pk.pee_extract(st, over, np_, p, t, out_len)),
                (lambda st=st, np_=np_, p=p:
                 pk.pee_extract_plain(st, over, np_, p, t, out_len)),
                2 * n + n + 2 * n + out_len)
               for p, st, np_ in ((1, s1, n1), (0, r1, n0))]
    print(f"2048x2048 u16 T={t}, {bits.size} bits, K4 out_len {out_len}",
          flush=True)
    yardsticks = {}
    stego = torch.empty_like(img_d)
    ovf = torch.empty(img_d.shape, dtype=torch.uint8, device=dev)
    yardsticks["embed"] = (
        "torch copy of the bytes (image -> stego, zero overflow map)",
        lambda: (stego.copy_(img_d), ovf.zero_()), 5 * n)
    flat = over.reshape(-1)
    bits_d = torch.empty(out_len, dtype=torch.uint8, device=dev)
    yardsticks["extract"] = (
        "torch copy of the bytes (stego -> restored, overflow map -> bits)",
        lambda: (stego.copy_(s1), bits_d.copy_(flat[:out_len])),
        2 * n + 2 * n + 2 * out_len)
    return {"embed": embed, "extract": extract}, yardsticks, n


def time_kernel(kernel, dev, only=None) -> None:
    from codec_tcc_tpu_torch.ops import pee_kernels as pk

    calls, yardsticks, n = plan(dev)
    tag = {"embed": "K3", "extract": "K4"}[kernel]
    for label, kern, plain, nbytes in calls[kernel]:
        row(f"{tag} {label}", kern, n, nbytes)
        row(f"plain {label}", plain, n)
    label, fn, nbytes = yardsticks[kernel]
    row(label, fn, n, nbytes)

    real = pk.library
    with tempfile.TemporaryDirectory() as tmp:
        for name in VARIANTS[kernel]:
            if only and not any(text in name for text in only):
                continue
            lib = variant_library(kernel, name, tmp)
            pk.library = lambda lib=lib: lib
            try:
                for label, kern, _, _ in calls[kernel]:
                    row(f"{tag} {label}, {name}", kern, n)
            finally:
                pk.library = real


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=sorted(SOURCES), default="embed")
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--sass", metavar="PATH")
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--time", action="store_true")
    ap.add_argument("--variant", action="append", metavar="TEXT",
                    help="time only the variants whose name holds TEXT "
                         "(repeatable; default: all)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA GPU: this probe runs the PEE kernels on the card")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    dev = torch.device("cuda")
    if args.ptxas:
        ptxas(args.kernel)
    if args.sass:
        sass(args.kernel, args.sass)
    if args.check:
        check(dev)
    if args.time:
        time_kernel(args.kernel, dev, args.variant)
    return 0


if __name__ == "__main__":
    sys.exit(main())
