#!/usr/bin/env python3
"""Iterate on one kernel of the PyTorch/CUDA port on one GPU, K3
``pee_embed``, K4 ``pee_extract``, K2 ``raster_extract`` or K1
``raster_embed``, without the whole ``chip_smoke.py``.

    python3 tools/torch_pee_embed_probe.py [--kernel embed|extract|raster_extract|raster_embed] [--ptxas] [--sass PATH] [--check] [--time]
    python3 tools/torch_pee_embed_probe.py --tiled-walls [--root PATH]

* ``--kernel``: the kernel the other options look at (default ``embed``,
  K3; ``extract`` is K4, ``raster_extract`` K2, ``raster_embed`` K1).
* ``--ptxas``: registers, shared memory and spills of every kernel in its
  source, ``codec_tcc_tpu_torch/csrc/pee_embed.cu``, ``pee_extract.cu``,
  ``raster_extract.cu`` or ``raster_embed.cu`` (``nvcc -Xptxas -v``).
* ``--sass PATH``: the uint16 kernel's SASS (``cuobjdump``) into PATH,
  and its instruction count by opcode.
* ``--check``: for K3 and K4 the look-back stress cases of
  ``tests/torch_pee_stress.py`` (``chip_smoke.py`` phase 2, both
  kernels): K3 against its plain version with K4 inverting each output,
  K4 at ``out_len`` and ``nproc`` at its tile boundaries and on forged
  inputs, all outputs exact, and the many-tile launch of each 20 times,
  identical; for K2 the boundary plans of ``tests/torch_raster_cases.py``
  and 20 repeats of a 2048x2048 five-plane launch, for K1 its plans there
  and the same repeats (``chip_smoke.py`` phase 2), then K1's first design
  on the uint8 sixteen-plane plan with maps (the fault it had) and on the
  five-plane plan.
* ``--time``: the kernel at its main path's largest plan: K3 and K4 at the
  2048x2048 uint16 3 Mbit PEE plan (the ``pee_cr2048_u16_3m`` parity case;
  K3 pass 0 and pass 1, K4 pass 1 and pass 0 as the decoder runs them), K1
  and K2 at the ``cr2048_u16_full`` raster plan (s = 5, 9,227,467 bits):
  device time per call from ``torch.profiler`` split by CUDA activity
  (kernel, memset), per call with CUDA events, the plain version, the
  bytes bound; beside it the same for the kernel's variants
  (:data:`VARIANTS`), built from patched copies of the sources (a part
  stubbed out, whose outputs are then wrong and only timed; another design
  of one part; other chunk and block sizes and register limits; for K1 and
  K2 also their first designs; for K1 a control, its own source rebuilt
  as a variant), a torch copy of the same bytes as a yardstick of the
  achievable rate and, for K2, the download of its bits beside that of
  the same bits packed eight to a byte; last the committed kernel again,
  so that the order of the rows can be told from the variants.
* ``--tiled-walls``: the tiled PEE path at the 2048x2048 uint16 3 Mbit
  plan (``pee_cr2048_u16_3m``): encode and decode host walls over K = 1,
  2, 4 bands of the card beside the single-device ones, in turns (three
  rounds, the order reversed each round; median of 3), then one tiled
  encode and decode at K = 4 under ``torch.profiler``: the copies between
  host and card (count, device time) and the host calls that issue them,
  synchronise and launch (count, host time). ``--root PATH`` runs the
  package and test helpers of another checkout (a parent commit unpacked
  with ``git archive``), built there: two checkouts compare in one call,
  in turns, one process each.

Prints the card's name and power limit first; fails without a GPU.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

# kernel -> its source, the header its variants may patch too, and the
# mangled name of its uint16 instantiation
SOURCES = {"embed": ("pee_embed.cu", "pee_common.cuh",
                     "_Z16pee_embed_kernelIt"),
           "extract": ("pee_extract.cu", "pee_common.cuh",
                       "_Z18pee_extract_kernelIt"),
           "raster_extract": ("raster_extract.cu", "raster_common.cuh",
                              "_Z21raster_extract_kernelIt"),
           "raster_embed": ("raster_embed.cu", "raster_common.cuh",
                            "_Z19raster_embed_kernelIt")}
_NO_SLEEP = (r"__nanosleep\(32\);", "")
_NO_TICKET = (r"pee_take_ticket\(ticket, &s_tile\)", "(int)blockIdx.x")
_NO_LOOKBACK = (r"pee_lookback\(\s*status.*?\);", "0u;")
# K3: no message bit loaded (the whole-image kernel's; the band kernels'
# helper has its own line)
_NO_MESSAGE = (r"(nproc\[b\] = pee_set_rank\(y, .*?)"
               r"const int n_emb = __popc\(proc & elig\);",
               r"\1const int n_emb = 0;")
# K4: the tiles' bits to disjoint places without the look-back (prefix 0
# would make every tile store to the same bytes, which the card serialises)
_K4_NO_LOOKBACK = (r"pee_lookback\(\s*status.*?\);", "(unsigned)(tile * agg);")
_K4_NO_BITS = (r"\*reinterpret_cast<uint4\*>\(seg \+ lo\) =",
               "if (s_bits[lo] == 7) *reinterpret_cast<uint4*>(seg) =")


# the whole-image kernels' vector loads with the rows above and below read
# as the run itself (the band kernels' loader in pee_common.cuh is left)
_ROWS_AS_RUN = (r"(const bool vec = live && pee_rows_vectorizable<T, RUN>"
                r"\(im, p0, w, n\);\s*if \(vec\) \{.*?)"
                r"pee_load_vec\(im \+ p0 - w, up\);(\s*)"
                r"pee_load_vec\(im \+ p0 \+ w, dn\);",
                r"\1pee_load_vec(im + p0, up);\2pee_load_vec(im + p0, dn);")


def _threads(n):
    return (r"#define PEE_THREADS 256", f"#define PEE_THREADS {n}")


def _min_blocks(kernel, n):
    """The kernel's launch bounds with at least n blocks per SM (none: no
    register cap)."""
    return (rf"__launch_bounds__\(PEE_THREADS(?:, \d+)?\)(\s*pee_{kernel}_kernel)",
            rf"__launch_bounds__(PEE_THREADS{'' if n is None else f', {n}'})\1")



# K2 as first written: one thread per output bit, a plane walk per bit
# (raster_extract.cu from its #include on); its entry points take the
# plane plan itself, not the segments
FIRST_K2_SOURCE = """// K2 raster_extract as first written.
#include "raster_common.cuh"

#define RASTER_THREADS 256

template <typename T>
__global__ void raster_extract_kernel(const T* __restrict__ stego,
                                      RasterPlan plan, int np, int s,
                                      long long n, long long out_len,
                                      uint8_t* __restrict__ out) {
    const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (j >= out_len) return;
    uint8_t bit = 0;
    for (int p = np - 1; p >= 0; --p) {
        const long long len = plan.len[p];
        if (len <= 0) continue;
        const long long rel = j - (long long)plan.off[p];
        if (rel < 0 || rel >= len) continue;
        if (p < s && rel < n) {
            long long pos = (long long)plan.start[p] + rel;   // start < n
            if (pos >= n) pos -= n;
            bit = (uint8_t)(((uint32_t)stego[pos] >> p) & 1u);
        }
        break;
    }
    out[j] = bit;
}

template <typename T>
static int launch_extract(const void* stego, const int* starts,
                          const int* lens, const int* offs, int np, int s,
                          long long n, long long out_len, void* out,
                          void* stream) {
    if (np < 0 || np > RASTER_MAX_PLANES || s < 0 || s > np || n <= 0 ||
        out_len < 0) {
        return (int)cudaErrorInvalidValue;
    }
    const RasterPlan plan = raster_make_plan(starts, lens, offs, np);
    if (out_len == 0) return 0;
    const long long blocks = (out_len + RASTER_THREADS - 1) / RASTER_THREADS;
    raster_extract_kernel<T><<<(unsigned)blocks, RASTER_THREADS, 0,
                               (cudaStream_t)stream>>>(
        (const T*)stego, plan, np, s, n, out_len, (uint8_t*)out);
    return (int)cudaGetLastError();
}

extern "C" {

int raster_extract_u8(const void* stego, const int* starts, const int* lens,
                      const int* offs, int np, int s, long long n,
                      long long out_len, void* out, void* stream) {
    return launch_extract<uint8_t>(stego, starts, lens, offs, np, s, n,
                                   out_len, out, stream);
}

int raster_extract_u16(const void* stego, const int* starts, const int* lens,
                       const int* offs, int np, int s, long long n,
                       long long out_len, void* out, void* stream) {
    return launch_extract<uint16_t>(stego, starts, lens, offs, np, s, n,
                                    out_len, out, stream);
}

}  // extern "C"
"""
FIRST_K2 = "first design (one thread per bit, plane walk)"

# K1 as first written (raster_embed.cu from its #include on): 8 pixels per
# thread, scalar loads and stores, one indexed message load per pixel and
# plane in 64-bit arithmetic, one map byte per plane; its maps come from
# the un-narrowed pixel, so on uint8 it writes message bits into map rows 8
# and up (the fault the current kernel repairs)
FIRST_K1_SOURCE = """// K1 raster_embed as first written.
#include "raster_common.cuh"

#define RASTER_THREADS 256

template <typename T>
__global__ void raster_embed_kernel(const T* __restrict__ img,
                                    const uint8_t* __restrict__ msg,
                                    long long msg_len, RasterPlan plan,
                                    int active_planes, int s, long long n,
                                    int emit_maps, T* __restrict__ stego,
                                    uint8_t* __restrict__ maps) {
    const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const long long base = g * 8;
    if (base >= n) return;
    const int cnt = (n - base) < 8 ? (int)(n - base) : 8;

    uint32_t orig[8];
    uint32_t v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
        orig[k] = k < cnt ? (uint32_t)img[base + k] : 0u;
        v[k] = orig[k];
    }
    for (int p = 0; p < active_planes; ++p) {
        const long long len = plan.len[p];
        if (len <= 0) continue;
        const long long start = plan.start[p];
        const long long off = plan.off[p];
        const uint32_t keep = ~(1u << p);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
            long long rel = base + k - start;
            if (rel < 0) rel += n;
            if (k < cnt && rel < len) {
                const long long idx = off + rel;
                const uint32_t bit = idx < msg_len ? (uint32_t)msg[idx] : 0u;
                v[k] = (v[k] & keep) | (bit << p);
            }
        }
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
        if (k < cnt) stego[base + k] = (T)v[k];
    }
    if (emit_maps) {
        const long long nbytes = n >> 3;   // the wrapper requires n % 8 == 0
        for (int p = 0; p < s; ++p) {
            uint32_t byte = 0;
#pragma unroll
            for (int k = 0; k < 8; ++k) {
                byte |= (((orig[k] ^ v[k]) >> p) & 1u) << (7 - k);
            }
            maps[(long long)p * nbytes + g] = (uint8_t)byte;
        }
    }
}

template <typename T>
static int launch_embed(const void* img, const void* msg, long long msg_len,
                        const int* starts, const int* lens, const int* offs,
                        int np, int s, long long n, int emit_maps, void* stego,
                        void* maps, void* stream) {
    if (np < 0 || np > RASTER_MAX_PLANES || s < 0 || s > np || n < 0) {
        return (int)cudaErrorInvalidValue;
    }
    const RasterPlan plan = raster_make_plan(starts, lens, offs, np);
    const long long groups = (n + 7) / 8;
    if (groups == 0) return 0;
    const long long blocks = (groups + RASTER_THREADS - 1) / RASTER_THREADS;
    raster_embed_kernel<T><<<(unsigned)blocks, RASTER_THREADS, 0,
                             (cudaStream_t)stream>>>(
        (const T*)img, (const uint8_t*)msg, msg_len, plan, s, s, n, emit_maps,
        (T*)stego, (uint8_t*)maps);
    return (int)cudaGetLastError();
}

extern "C" {

int raster_embed_u8(const void* img, const void* msg, long long msg_len,
                    const int* starts, const int* lens, const int* offs,
                    int np, int s, long long n, int emit_maps, void* stego,
                    void* maps, void* stream) {
    return launch_embed<uint8_t>(img, msg, msg_len, starts, lens, offs, np, s,
                                 n, emit_maps, stego, maps, stream);
}

int raster_embed_u16(const void* img, const void* msg, long long msg_len,
                     const int* starts, const int* lens, const int* offs,
                     int np, int s, long long n, int emit_maps, void* stego,
                     void* maps, void* stream) {
    return launch_embed<uint16_t>(img, msg, msg_len, starts, lens, offs, np,
                                  s, n, emit_maps, stego, maps, stream);
}

const char* codec_kernels_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
"""
FIRST_K1 = "first design (8 pixels per thread, scalar, 64-bit indices)"


def _k1_pixels(n):
    return (r"#define RASTER_EMBED_PIXELS 16",
            f"#define RASTER_EMBED_PIXELS {n}")


def _k1_threads(n):
    return (r"#define RASTER_EMBED_THREADS 128",
            f"#define RASTER_EMBED_THREADS {n}")


def _k2_bytes(n):
    return (r"#define RASTER_EXTRACT_BYTES 16",
            f"#define RASTER_EXTRACT_BYTES {n}")


def _k2_threads(n):
    return (r"#define RASTER_EXTRACT_THREADS 256",
            f"#define RASTER_EXTRACT_THREADS {n}")


# Design 2: a block whose 4,096 bits lie in one segment stages its pixels
# in shared memory with one coalesced pass of aligned vectors; its threads
# then shift their runs out of shared memory. Other blocks run design 1.
_K2_STAGED = """    if (j0 >= out_len) return;
    {
        constexpr int SPAN = RASTER_EXTRACT_THREADS * RASTER_EXTRACT_BYTES;
        __shared__ uint4 s_px[SPAN * (int)sizeof(T) / 16 + 1];
        const unsigned b0 = j0 - threadIdx.x * RASTER_EXTRACT_BYTES;
        const int kb = raster_find_segment(seg, b0);
        if (b0 + SPAN <= (unsigned)seg.begin[kb + 1] && seg.plane[kb] >= 0) {
            const uint8_t* a = reinterpret_cast<const uint8_t*>(
                stego + seg.pos[kb] + (b0 - seg.begin[kb]));
            const int r = (int)((uintptr_t)a & 15u);
            const uint4* v = reinterpret_cast<const uint4*>(a - r);
            const int nv = (r + SPAN * (int)sizeof(T) + 15) / 16;
            for (int i = threadIdx.x; i < nv; i += RASTER_EXTRACT_THREADS) {
                s_px[i] = v[i];
            }
            __syncthreads();
            uint32_t o[RASTER_EXTRACT_BYTES / 4];
            raster_bits_of_run<T, RASTER_EXTRACT_BYTES>(
                reinterpret_cast<const T*>(
                    reinterpret_cast<const uint8_t*>(s_px) + r) +
                    threadIdx.x * RASTER_EXTRACT_BYTES,
                seg.plane[kb], o);
            raster_store_chunk<RASTER_EXTRACT_BYTES>(out + j0, o,
                                                     out_len - j0);
            return;
        }
    }
"""

# kernel -> variant name -> [(pattern, replacement), ...], each applied
# where it matches (once over the kernel's source and its header); the
# variants that change what is computed are timed only
VARIANTS = {
    "embed": {
        "no look-back (prefix 0; time only)": [_NO_LOOKBACK],
        "tile from blockIdx, no ticket (time only)": [_NO_TICKET],
        "no message load (bit 0; time only)": [_NO_MESSAGE],
        "no look-back, ticket or message load (time only)":
            [_NO_LOOKBACK, _NO_TICKET, _NO_MESSAGE],
        "look-back without sleep": [_NO_SLEEP],
        "rows above and below read as the run itself (time only)":
            [_ROWS_AS_RUN],
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
            [(r"(pee_extract_run<T, false>\(.*?\);\s*)"
              r"pee_store_run\(out_im, p0, n, out\);",
              r"\1if (out[0] == 12345 && out[1] == 54321) out_im[0] = 0;")],
        "no overflow-map load (time only)":
            [(r"if \(live\) ovm = pee_load_nonzero16\(over \+ img_off, p0, "
              r"n\);", "")],
        "rows above and below read as the run itself (time only)":
            [_ROWS_AS_RUN],
        "restore stored after the look-back":
            [(r"unsigned expd = 0, bitm = 0;\s*if \(live\) \{\s*T out\[RUN\];",
              "unsigned expd = 0, bitm = 0;\n    T out[RUN];\n    if (live) {"),
             (r"(pee_extract_run<T, false>\(.*?\);\s*)"
              r"pee_store_run\(out_im, p0, n, out\);", r"\1"),
             (r"const int prefix = s_prefix;",
              "const int prefix = s_prefix;\n"
              "    if (live) pee_store_run(out_im, p0, n, out);")],
        "bits stored by each thread at its ranks (no staging)":
            [(r"pee_extract_store_bits\(expd, bitm, thread_excl, prefix, agg,"
              r"\s*bits \+ \(long long\)b \* out_len, out_len, s_bits\);",
              "uint8_t* row = bits + (long long)b * out_len;\n"
              "    unsigned rest = expd;\n"
              "    for (long long r = (long long)prefix + thread_excl; rest;"
              " ++r, rest &= rest - 1) {\n"
              "        if (r < out_len) row[r] = (uint8_t)((bitm >> "
              "(__ffs(rest) - 1)) & 1u);\n    }")],
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
    "raster_extract": {
        FIRST_K2: [(r"\A// K2 raster_extract.*\Z",
                  lambda m: FIRST_K2_SOURCE)],
        "no stores (time only)":
            [(r"raster_store_chunk<CHUNK>\(out \+ j0, o, out_len - j0\);",
              "if (o[0] == 0x12345678u) out[j0] = 1;")],
        "no pixel loads on the vector path (time only)":
            [(r"raster_bits_of_run<T, CHUNK>\(\s*stego.*?\);",
              "o[0] = j0 >> p;")],
        "design 2: block stages its pixels in shared memory":
            [(r"    if \(j0 >= out_len\) return;\n",
              lambda m: _K2_STAGED)],
        "8 bytes per thread": [_k2_bytes(8)],
        "32 bytes per thread": [_k2_bytes(32)],
        "128 threads per block": [_k2_threads(128)],
        "512 threads per block": [_k2_threads(512)],
    },
    "raster_embed": {
        "control: the committed source, rebuilt as a variant":
            [_k1_threads(128)],
        FIRST_K1: [(r"\A// K1 raster_embed.*\Z", lambda m: FIRST_K1_SOURCE)],
        "no message loads inside windows (time only)":
            [(r"raster_load_words\(msg \+ m0, m\);",
              "for (int i = 0; i < MW; ++i) m[i] = m0 + i;")],
        "no map stores (time only)":
            [(r"raster_store_bytes<MB>\(row, word\);",
              "if (word == 0x12345u) row[0] = 1;")],
        "no stego stores (time only)":
            [(r"reinterpret_cast<uint4\*>\(stego \+ base\)\[i\] =\s*"
              r"make_uint4\(.*?\);",
              "if (v[4 * i] == 0x12345678u) stego[base] = 0;")],
        "message bytes loaded one by one inside windows":
            [(r"if \(m0 \+ CHUNK <= msg_len\) \{", "if (false) {")],
        "every chunk pixel by pixel (no inside path)":
            [(r"if \(full && rel0 \+ CHUNK <= lim\) \{", "if (false) {")],
        "8 pixels per thread": [_k1_pixels(8)],
        "32 pixels per thread": [_k1_pixels(32)],
        "256 threads per block": [_k1_threads(256)],
        "512 threads per block": [_k1_threads(512)],
        "128 threads, at least 16 blocks per SM (32 registers)":
            [(r"__launch_bounds__\(RASTER_EMBED_THREADS\)",
              "__launch_bounds__(RASTER_EMBED_THREADS, 16)")],
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
    body = next(f for f in funcs if f.startswith(SOURCES[kernel][2]))
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w", encoding="utf-8") as f:
        f.write(body)
    ops = collections.Counter(
        m.group(1).split(".")[0]
        for m in re.finditer(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9.]+)",
                             body))
    print(f"{kernel} u16 SASS: {sum(ops.values())} instructions -> {out}; "
          f"{dict(ops.most_common(30))}")


def check(kernel, dev) -> None:
    import chip_smoke

    if kernel == "raster_extract":
        print(chip_smoke.phase2_k2(dev)[1], flush=True)
    elif kernel == "raster_embed":
        print(chip_smoke.phase2_k1(dev)[1], flush=True)
        with tempfile.TemporaryDirectory() as tmp:
            first_k1_on_repair_case(variant_library("raster_embed", FIRST_K1,
                                                    tmp), dev)
    else:
        print(chip_smoke.phase2_pee_stress(dev), flush=True)


def first_k1_on_repair_case(lib, dev) -> None:
    """The first design of K1 on the repair case (uint8 64x64, the
    sixteen-plane plan, s = 12, maps) and on a 2048x2048 uint16 five-plane
    plan, against the plain version: prints where it differs."""
    import numpy as np
    import torch
    import torch_raster_cases as rc
    from codec_tcc_tpu_torch.ops import raster_kernels as rk

    rng = np.random.default_rng(12)
    real = rk.library
    rk.library = lambda: lib
    try:
        for h, w, dt, plan in (
                (64, 64, np.uint8, rc.sixteen_plane_plan(64 * 64)),
                (2048, 2048, np.uint16, rc.five_plane_plan(2048 * 2048, 5))):
            label, s, starts, lens, offs, msg_len = plan
            img = torch.from_numpy(rng.integers(
                0, 1 << (8 * np.dtype(dt).itemsize), (h, w)).astype(dt)).to(dev)
            msg = torch.from_numpy(
                rng.integers(0, 2, msg_len).astype(np.uint8)).to(dev)
            got = rk.raster_embed(img, msg, starts, lens, offs, s,
                                  emit_maps=True)
            torch.cuda.synchronize()
            ref = rk.raster_embed_plain(img, msg, starts, lens, offs, s,
                                        emit_maps=True)
            rows = [p for p in range(s) if not torch.equal(got[1][p], ref[1][p])]
            print(f"  {FIRST_K1} on {h}x{w} {np.dtype(dt).name} {label} s={s}: "
                  f"stego {'equal' if torch.equal(got[0], ref[0]) else 'differs'}"
                  f", map rows differing from plain {rows}", flush=True)
    finally:
        rk.library = real


def variant_library(kernel, name, tmp):
    """The kernel library built from csrc with VARIANTS[kernel][name]
    applied, in its own build directory."""
    from codec_tcc_tpu_torch.ops import kernel_library as kl

    src = os.path.join(tmp, f"csrc{len(os.listdir(tmp))}")
    shutil.copytree(kl.CSRC, src)
    texts = {}
    for fname in SOURCES[kernel][:2]:
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


def row(label, fn, nbytes=None, ops=0):
    """Prints one timed line: device time split by activity, per call."""
    import chip_smoke

    split = profile_split(fn)
    dev_ms = sum(split.values())
    ms = chip_smoke.cuda_median_ms(fn)
    bound = ("" if nbytes is None else
             f", bound {chip_smoke.bound(nbytes, ops)[0]:.4f} ms "
             f"({nbytes} B)")
    print(f"  {label}: device {dev_ms:.4f} ms "
          f"{ {k: round(v, 4) for k, v in split.items()} }, per call "
          f"{ms:.4f} ms{bound}", flush=True)


def pee_plan(dev):
    """The 3 Mbit 2048x2048 uint16 plan: the calls of both passes of K3
    and K4 as (label, kernel call, plain call, bytes the function must
    move, its operations), and a yardstick for each as (label, call,
    bytes)."""
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
    ops = chip_smoke.K3_K4_OPS_PER_PIXEL * n
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
              2 * n + 2 * n + n + int(used), ops)
             for p, im, base, wv, used in ((0, img_d, zero, want, u0),
                                           (1, s0, u0, want - u0, u1))]
    extract = [(f"pass {p}",
                (lambda st=st, np_=np_, p=p:
                 pk.pee_extract(st, over, np_, p, t, out_len)),
                (lambda st=st, np_=np_, p=p:
                 pk.pee_extract_plain(st, over, np_, p, t, out_len)),
                2 * n + n + 2 * n + out_len, ops)
               for p, st, np_ in ((1, s1, n1), (0, r1, n0))]
    print(f"2048x2048 u16 T={t}, {bits.size} bits, K4 out_len {out_len}",
          flush=True)
    yardsticks = {}
    stego = torch.empty_like(img_d)
    ovf = torch.empty(img_d.shape, dtype=torch.uint8, device=dev)
    yardsticks["embed"] = [(
        "torch copy of the bytes (image -> stego, zero overflow map)",
        lambda: (stego.copy_(img_d), ovf.zero_()), 5 * n)]
    flat = over.reshape(-1)
    bits_d = torch.empty(out_len, dtype=torch.uint8, device=dev)
    yardsticks["extract"] = [(
        "torch copy of the bytes (stego -> restored, overflow map -> bits)",
        lambda: (stego.copy_(s1), bits_d.copy_(flat[:out_len])),
        2 * n + 2 * n + 2 * out_len)]
    return {"embed": embed, "extract": extract}, yardsticks


def raster_plan(dev):
    """K2 at the ``cr2048_u16_full`` plan (the stego encoded on the card),
    as :func:`pee_plan` gives K3 and K4, plus the first design's call on a
    library built from its source and the downloads of the bits."""
    import numpy as np
    import torch
    import chip_smoke
    from codec_tcc_tpu_torch.ops import kernel_library as kl
    from codec_tcc_tpu_torch.ops import raster_kernels as rk

    img, _, res, (starts, lens, offs) = cr2048_encode()
    meta, n = res.meta, img.size
    s, out_len = meta.s, int(meta.payload_bits)
    stego = torch.from_numpy(res.stego).to(dev)
    covered = np.zeros(n, bool)
    for p in range(s):
        covered[(int(starts[p]) + np.arange(min(int(lens[p]), n))) % n] = True
    nbytes = 2 * int(covered.sum()) + out_len
    segs = rk.extract_segments(starts, lens, offs, s, n, out_len, 16)
    print(f"2048x2048 u16 s={s}, {out_len} bits, {segs[2].size} segments "
          f"{list(zip(segs[0].tolist(), segs[2].tolist()))}", flush=True)
    calls = [("cr2048_u16_full",
              lambda: rk.raster_extract(stego, starts, lens, offs, s, out_len),
              lambda: rk.raster_extract_plain(stego, starts, lens, offs, s,
                                              out_len),
              nbytes, 3 * out_len)]
    want = rk.raster_extract(stego, starts, lens, offs, s, out_len)

    def first_calls(lib):
        fn = lib.raster_extract_u16
        i32, i64, ptr = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
        # stego, starts, lens, offs, np, s, n, out_len, out, stream
        fn.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i64, i64, ptr, ptr]

        def call():
            # its wrapper's host steps, so that per call compares too
            st, ln, of = rk._plan_arrays(starts, lens, offs, s, n)
            out = torch.empty(out_len, dtype=torch.uint8, device=dev)
            kl.check(lib, fn(stego.data_ptr(), st.ctypes.data, ln.ctypes.data,
                             of.ctypes.data, st.size, s, n, out_len,
                             out.data_ptr(), kl.stream_ptr(stego)), "first K2")
            return out
        chip_smoke.check(torch.equal(call(), want), "the first K2 differs")
        return [("cr2048_u16_full", call, None, None, 0)]

    src = torch.zeros(nbytes // 2, dtype=torch.uint8, device=dev)
    dst = torch.empty_like(src)
    yard = [("torch copy of the bytes (half read, half written)",
             lambda: dst.copy_(src), nbytes)]
    packed = torch.zeros(out_len // 8, dtype=torch.uint8, device=dev)
    for label, t in ((f"{out_len} bytes (the bits)", want),
                     (f"{out_len // 8} bytes (packed)", packed)):
        def download(t=t):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            t.cpu()
            return (time.perf_counter() - t0) * 1e3
        download()
        walls = sorted(download() for _ in range(20))
        print(f"  download of {label}: {walls[10]:.4f} ms host wall "
              f"(median of 20)", flush=True)
    return calls, yard, first_calls


def raster_embed_plan(dev):
    """K1 at the ``cr2048_u16_full`` plan as the encoder launches it (maps
    on), as :func:`pee_plan` gives K3 and K4, and a torch copy of the same
    bytes."""
    import torch
    import chip_smoke
    from codec_tcc_tpu_torch.ops import raster_kernels as rk

    img, bits, res, (starts, lens, offs) = cr2048_encode()
    n, s = img.size, res.meta.s
    nbytes, ops = chip_smoke.k1_work(n, img.itemsize, s, lens, bits.size)
    img_d = torch.from_numpy(img).to(dev)
    msg_d = torch.from_numpy(bits).to(dev)
    print(f"2048x2048 u16 s={s}, {bits.size} bits, starts "
          f"{starts[:s].tolist()} lens {lens[:s].tolist()} offs "
          f"{offs[:s].tolist()}", flush=True)
    calls = [("cr2048_u16_full",
              lambda: rk.raster_embed(img_d, msg_d, starts, lens, offs, s,
                                      emit_maps=True),
              lambda: rk.raster_embed_plain(img_d, msg_d, starts, lens, offs,
                                            s, emit_maps=True),
              nbytes, ops)]
    src = torch.zeros(nbytes // 2, dtype=torch.uint8, device=dev)
    dst = torch.empty_like(src)
    yard = [("torch copy of the bytes (half read, half written)",
             lambda: dst.copy_(src), nbytes)]
    return calls, yard


def cr2048_encode():
    """The ``cr2048_u16_full`` case encoded on the card: (image, payload
    bits, encode result, its plane plan as the encoder launches it)."""
    import chip_smoke
    import codec_tcc_tpu_torch as port
    import torch_port_cases as cases
    from codec_tcc_tpu_torch import pipeline

    case = cases.BY_NAME["cr2048_u16_full"]
    img, _, bits = chip_smoke.case_payload(case)
    res = port.encode_array(img, bits,
                            port.EncodeConfig(strategy=case.strategy),
                            bits_stored=case.bits_stored, device="cuda")
    plan = pipeline._plane_plan_from_meta(
        res.meta, img.size, pipeline._plane_bucket(res.meta.s, 16))
    return img, bits, res, plan


def time_kernel(kernel, dev, only=None) -> None:
    from codec_tcc_tpu_torch.ops import pee_kernels as pk
    from codec_tcc_tpu_torch.ops import raster_kernels as rk

    module = rk if kernel.startswith("raster") else pk
    special = {}
    if kernel == "raster_extract":
        calls, yard, special[FIRST_K2] = raster_plan(dev)
    elif kernel == "raster_embed":
        calls, yard = raster_embed_plan(dev)
    else:
        all_calls, yardsticks = pee_plan(dev)
        calls, yard = all_calls[kernel], yardsticks[kernel]
    tag = {"embed": "K3", "extract": "K4", "raster_extract": "K2",
           "raster_embed": "K1"}[kernel]
    for label, kern, plain, nbytes, ops in calls:
        row(f"{tag} {label}", kern, nbytes, ops)
        row(f"plain {label}", plain)
    for label, fn, nbytes in yard:
        row(label, fn, nbytes)

    real = module.library
    with tempfile.TemporaryDirectory() as tmp:
        for name in VARIANTS[kernel]:
            if only and not any(text in name for text in only):
                continue
            lib = variant_library(kernel, name, tmp)
            module.library = lambda lib=lib: lib
            try:
                for label, kern, _, _, _ in (special[name](lib)
                                             if name in special else calls):
                    row(f"{tag} {label}, {name}", kern)
            finally:
                module.library = real
    # the committed kernel once more: what the order alone does to a time
    for label, kern, _, _, _ in calls:
        row(f"{tag} {label}, again after the variants", kern)


def tiled_walls(dev) -> None:
    """See ``--tiled-walls`` in the module's docstring."""
    import statistics

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import codec_tcc_tpu_torch as port
    import torch_port_cases as cases
    from codec_tcc_tpu_torch.parallel import make_mesh, tile_pee

    print(f"package: {os.path.dirname(port.__file__)}")
    case = cases.BY_NAME[cases.TILED_PEE]
    img, bits = cases.image(case), cases.payload_bits(case, 0)
    cfg = port.EncodeConfig(strategy="pee")
    blob = port.encode_array(img, bits, cfg, bits_stored=12,
                             device=dev).container
    calls = {"single-device": (
        lambda: port.encode_array(img, bits, cfg, bits_stored=12,
                                  device=dev),
        lambda: port.decode_container(blob, device=dev))}
    for k in cases.TILED_KS:
        mesh = make_mesh(devices=[dev] * k, axes=("tile",))
        calls[f"K={k}"] = (
            lambda mesh=mesh: tile_pee.encode_array_tiled_pee(
                img, bits, cfg, mesh, bits_stored=12),
            lambda mesh=mesh: tile_pee.decode_container_tiled_pee(blob,
                                                                  mesh))
    for enc, dec in calls.values():   # warm: builds, allocator, caches
        enc()
        dec()
    walls = {what: ([], []) for what in calls}
    order = list(calls)
    for rnd in range(3):
        for what in (order if rnd % 2 == 0 else order[::-1]):
            for fn, times in zip(calls[what], walls[what]):
                t0 = time.perf_counter()
                fn()
                times.append((time.perf_counter() - t0) * 1e3)
    single = [statistics.median(v) for v in walls["single-device"]]
    for what, (enc, dec) in walls.items():
        e, d = statistics.median(enc), statistics.median(dec)
        print(f"tiled PEE 2048x2048 u16 3 Mbit {what}: encode {e:.2f} ms "
              f"({e / single[0]:.3f}x single), decode {d:.2f} ms "
              f"({d / single[1]:.3f}x single) host wall, median of 3 in "
              f"turns", flush=True)

    for what, fn in zip(("encode", "decode"), calls["K=4"]):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        copies, host = {}, {}
        for evt in prof.key_averages():
            if evt.device_type == DeviceType.CUDA and (
                    evt.key.startswith("Memcpy")
                    or evt.key.startswith("Memset")):
                copies[evt.key] = (evt.count,
                                   evt.self_device_time_total / 1e3)
            elif evt.device_type == DeviceType.CPU and evt.key in (
                    "cudaMemcpyAsync", "cudaStreamSynchronize",
                    "cudaLaunchKernel", "cudaMemsetAsync"):
                host[evt.key] = (evt.count, evt.self_cpu_time_total / 1e3)
        print(f"tiled {what} K=4 under the profiler: device copies "
              f"{ {k: f'{n} x, {ms:.3f} ms' for k, (n, ms) in copies.items()} }"
              f"; host calls "
              f"{ {k: f'{n} x, {ms:.3f} ms' for k, (n, ms) in host.items()} }",
              flush=True)


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
    ap.add_argument("--tiled-walls", action="store_true")
    ap.add_argument("--root", metavar="PATH",
                    help="the checkout whose package --tiled-walls runs")
    args = ap.parse_args()
    if args.root:
        root = os.path.abspath(args.root)
        sys.path[:0] = [root, os.path.join(root, "tests")]
    if not torch.cuda.is_available():
        sys.exit("no CUDA GPU: this probe runs the port's kernels on the card")
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
        check(args.kernel, dev)
    if args.time:
        time_kernel(args.kernel, dev, args.variant)
    if args.tiled_walls:
        tiled_walls(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
