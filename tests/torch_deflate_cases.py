"""Images whose deflate streams exercise what the zlib-exact ``Z_RLE``
encoder (``codec_tcc_tpu_torch/ops/deflate_rle.py``, ``csrc/deflate_rle.cu``)
must get right, shared by the CPU tests of its plain version and the GPU
tests of its kernels. A stream of bytes is a ``(1, n)`` uint8 image.

* 1 to 4 bytes (a run of 3 is three literals, a run of 4 a literal and
  a 3-byte match);
* all-zero and constant images (one run: literal, then 258-byte matches);
* runs of 257 to 261 and 516 bytes (the remainder after 258-byte matches:
  none, a match, one or two literals);
* random bytes, so stored blocks, and a second block that zlib's window
  slide forces from stored to Huffman (``buf == NULL``);
* streams of exactly 32,767 and 32,768 tokens (a full block, then an empty
  or a one-token last block);
* uint8 and uint16 images of odd H*W (the uint16 split at an odd offset);
* the seeded phantom of the benchmark at 64x64 and 256x256.
"""

from __future__ import annotations

import numpy as np

import torch_port_cases as cases


def _distinct_neighbours(n: int) -> np.ndarray:
    """n bytes, no two neighbours equal: n tokens."""
    return ((np.arange(n) * 7 + 3) % 251).astype(np.uint8)


def _stream(x) -> np.ndarray:
    return np.asarray(x, dtype=np.uint8).reshape(1, -1)


def phantom(h: int, w: int, seed: int = 7) -> np.ndarray:
    """The benchmark's uint16 phantom (12 bits stored) at ``h`` x ``w``."""
    return cases.image(cases.Case(f"phantom_{h}x{w}", h, w, "uint16", 12,
                                  "text", "hybrid", seed))


def _run(r: int) -> np.ndarray:
    rng = np.random.default_rng(r)
    return _stream(np.concatenate([rng.integers(0, 256, 7), np.full(r, 7),
                                   rng.integers(0, 256, 5)]))


def _random(shape, hi: int, seed: int, dtype=np.uint8) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, hi, shape).astype(dtype)


_BUILDERS = {
    "bytes1": lambda: _random((1, 1), 256, 1),
    "bytes2": lambda: _random((1, 2), 256, 2),
    "bytes3": lambda: _stream([5, 5, 5]),
    "bytes4": lambda: _stream([5, 5, 5, 5]),
    "zeros_u16_64x64": lambda: np.zeros((64, 64), np.uint16),
    "const_u8_33x35": lambda: np.full((33, 35), 9, np.uint8),
    **{f"run{r}": (lambda r=r: _run(r))
       for r in (257, 258, 259, 260, 261, 516)},
    "random_70000": lambda: _random((1, 70000), 256, 70000),
    "tokens_32767": lambda: _stream(_distinct_neighbours(32767)),
    "tokens_32768": lambda: _stream(_distinct_neighbours(32768)),
    "odd_u16_37x53": lambda: _random((37, 53), 4096, 37, np.uint16),
    "odd_u8_41x43": lambda: _random((41, 43), 7, 41),
    "phantom_64x64": lambda: phantom(64, 64),
    "phantom_256x256": lambda: phantom(256, 256),
}

NAMES = tuple(_BUILDERS)


def case(name: str) -> np.ndarray:
    return _BUILDERS[name]()
