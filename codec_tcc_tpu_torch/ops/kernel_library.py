"""Build and bind the port's hand-written CUDA kernels.

Every kernel of the package lives in ``codec_tcc_tpu_torch/csrc``. At first
use, :func:`build_library` compiles each source to an object with its own
``nvcc`` (all started together, so the build takes as long as the slowest
source) and links them into ONE shared library in
``codec_tcc_tpu_torch/build/``, named by a hash of the sources and flags so
that a changed source builds anew. :func:`library` loads it with ``ctypes``
and declares every entry point's C signature. The kernels launch on
PyTorch's current stream (:func:`stream_ptr`) and return a CUDA error code,
which :func:`check` turns into an exception.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

__all__ = ["BUILD_DIR", "SOURCES", "build_library", "check", "library",
           "stream_ptr"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
SOURCES = ("raster_embed.cu", "raster_extract.cu", "pee_embed.cu",
           "pee_extract.cu")
HEADERS = ("raster_common.cuh", "pee_common.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cand = os.path.join(cuda_home or "/usr/local/cuda", "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "kernels are built from codec_tcc_tpu_torch/csrc at first use"
    )


def build_library() -> Path:
    """Compile ``csrc/*.cu`` into one shared library (cached by a hash of
    the sources and flags) and return its path. The sources compile in
    parallel, one ``nvcc`` each, and one more ``nvcc`` links them."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        digest.update(name.encode())
        digest.update((CSRC / name).read_bytes())
    out = BUILD_DIR / f"libcodec_kernels_{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{digest.hexdigest()[:16]}.{os.getpid()}"
    objs = [str(BUILD_DIR / f"{Path(name).stem}.{tag}.o") for name in SOURCES]
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(CSRC / name)]
            for name, obj in zip(SOURCES, objs)]
    procs = [subprocess.Popen(cmd, stderr=subprocess.PIPE, text=True)
             for cmd in cmds]
    try:
        errors = [p.communicate()[1] for p in procs]
        if any(p.returncode for p in procs):
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
        link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                               *objs], stderr=subprocess.PIPE, text=True)
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stderr}")
        os.replace(tmp, out)          # atomic: concurrent builds agree
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
        for path in (*objs, tmp):
            Path(path).unlink(missing_ok=True)
    return out


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_library()))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    signatures = {
        # img, msg, msg_len, starts, lens, offs, np, s, n, emit_maps,
        # stego, maps, stream
        "raster_embed": [ptr, ptr, i64, ptr, ptr, ptr, i32, i32, i64, i32,
                         ptr, ptr, ptr],
        # imgs, msgs, msg_len (per image), table (host copy, device copy),
        # batch, max_s, n, emit_maps, stego, maps, stream
        "raster_embed_batch": [ptr, ptr, i64, ptr, ptr, i32, i32, i64, i32,
                               ptr, ptr, ptr],
        # stego, begin, pos, plane (the segment plan), count, n, out_len,
        # out, stream
        "raster_extract": [ptr, ptr, ptr, ptr, i32, i64, i64, ptr, ptr],
        # stegos, segment tables (host copy, device copy), batch, n,
        # out_len, out, stream
        "raster_extract_batch": [ptr, ptr, ptr, i32, i64, i64, ptr, ptr],
        # img, msg, msg_len, msg_base, want, batch, h, w, parity, t,
        # max_val, stego, over, scratch (used, nproc, cap at its front),
        # stream
        "pee_embed": [ptr, ptr, i64, ptr, ptr, i32, i32, i32, i32, i32, i32,
                      ptr, ptr, ptr, ptr],
        # stego, over, nproc, batch, h, w, parity, t, out_len, restored,
        # buf (scratch with nbits at its front, then the bit rows), stream
        "pee_extract": [ptr, ptr, ptr, i32, i32, i32, i32, i32, i64, ptr,
                        ptr, ptr],
        # their shard mode: K3's arguments with top, bottom, row0 and
        # rank_base after want, and batch, lh, h, w for batch, h, w
        "pee_embed_band": [ptr, ptr, i64, ptr, ptr, ptr, ptr, ptr, ptr, i32,
                           i32, i32, i32, i32, i32, i32, ptr, ptr, ptr, ptr],
        # K4's with top, bottom and row0 after nproc, and batch, lh, h, w
        "pee_extract_band": [ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32,
                             i32, i32, i32, i64, ptr, ptr, ptr],
    }
    for name, argtypes in signatures.items():
        for dt in ("u8", "u16"):
            fn = getattr(lib, f"{name}_{dt}")
            fn.argtypes = argtypes
            fn.restype = i32
    lib.pee_tile_pixels.argtypes = []
    lib.pee_tile_pixels.restype = i32
    for name in ("pee_embed_scratch_ints", "pee_extract_scratch_bytes"):
        getattr(lib, name).argtypes = [i32, i32, i32]
        getattr(lib, name).restype = i64
    lib.codec_kernels_error_string.argtypes = [i32]
    lib.codec_kernels_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.codec_kernels_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err} ({msg})")


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream
