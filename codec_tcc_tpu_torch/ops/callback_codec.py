# Port of codec_tcc_tpu/ops/callback_codec.py. The same code:
# _encode_host and _decode_host. Torch: compress_stage, decompress_stage and
# roundtrip_in_jit, a plain host call between the stages instead of a
# jax.experimental.io_callback inside a jitted graph.
"""Transport codecs as fixed-size byte-buffer stages.

The JAX package wraps any registry codec as a pair of host callbacks inside
a jitted graph: XLA needs static shapes, so the compressed stream lives in a
``(capacity,) uint8`` buffer plus a length scalar. Torch has no traced
graph, so here the codec is a plain host call between the stages; the
stages keep the same buffers, the same names and the same errors, and
their tensors stay on the image's (or the buffer's) device.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..device import download, upload
from ..io.codecs import get as get_codec

__all__ = ["compress_stage", "decompress_stage", "roundtrip_in_jit"]


def _encode_host(codec_name: str, capacity: int, image: np.ndarray):
    codec = get_codec(codec_name)
    blob = codec.encode(np.asarray(image))
    if len(blob) > capacity:
        raise ValueError(
            f"codec '{codec_name}' output ({len(blob)} B) exceeds the "
            f"reserved callback buffer ({capacity} B)"
        )
    buf = np.zeros(capacity, dtype=np.uint8)
    buf[: len(blob)] = np.frombuffer(blob, dtype=np.uint8)
    return buf, np.int32(len(blob))


def _decode_host(codec_name: str, shape: Tuple[int, int], dtype, buf: np.ndarray, n: np.ndarray):
    codec = get_codec(codec_name)
    arr = codec.decode(bytes(np.asarray(buf)[: int(n)]))
    if arr.shape != tuple(shape):
        raise ValueError(f"decoded shape {arr.shape} != expected {tuple(shape)}")
    return arr.astype(dtype)


def compress_stage(image: torch.Tensor, codec_name: str, capacity: int):
    """``image -> (buffer (capacity,) uint8, length 0-d int32)``, both on
    ``image.device``. A blob longer than ``capacity`` raises
    ``ValueError``."""
    buf, n = _encode_host(codec_name, capacity, download(image))
    return (upload(buf, image.device),
            upload(np.array(int(n), dtype=np.int32), image.device))


def decompress_stage(buf: torch.Tensor, n: torch.Tensor, codec_name: str,
                     shape: Tuple[int, int], dtype):
    """Exact inverse of :func:`compress_stage`: the image of ``shape`` and
    ``dtype`` (a numpy or torch dtype) on ``buf.device``. A decoded shape
    other than ``shape`` raises ``ValueError``."""
    arr = _decode_host(codec_name, shape, _numpy_dtype(dtype),
                       download(buf), int(download(n)))
    return upload(arr, buf.device)


def roundtrip_in_jit(image: torch.Tensor, codec_name: str,
                     capacity: int) -> torch.Tensor:
    """Compress, then decompress, as the JAX package does inside one jitted
    graph. Torch has no traced graph: the codec runs as a plain host call
    between the two stages."""
    image = torch.as_tensor(image)
    buf, n = compress_stage(image, codec_name, capacity)
    return decompress_stage(buf, n, codec_name, tuple(image.shape),
                            image.dtype)


def _numpy_dtype(dtype) -> np.dtype:
    """A torch dtype's numpy counterpart; a numpy dtype as it is."""
    if isinstance(dtype, torch.dtype):
        return torch.empty((), dtype=dtype).numpy().dtype
    return np.dtype(dtype)
