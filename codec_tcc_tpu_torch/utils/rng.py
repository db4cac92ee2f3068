# Port of codec_tcc_tpu/utils/rng.py: the same code; only import lines and prose differ.
"""Deterministic permutation utilities.

The reference shuffles the segment->plane destination order with
``random.seed(42); random.shuffle(segment_indices)``
(``src/codec.py:262-264``), which both hardcodes the seed and
mutates *global* RNG state (defect register SURVEY.md §2.4 B7). We reproduce
the exact same Mersenne-Twister permutation through a private ``random.Random``
instance, parameterized by seed, without touching global state.
"""

from __future__ import annotations

import random
from typing import List

DEFAULT_SEGMENT_SHUFFLE_SEED = 42


def shuffled_indices(n: int, seed: int = DEFAULT_SEGMENT_SHUFFLE_SEED) -> List[int]:
    """Return ``list(range(n))`` shuffled exactly as the reference does.

    ``random.Random(seed).shuffle`` produces the identical permutation to
    ``random.seed(seed); random.shuffle`` (same Fisher-Yates over the same
    Mersenne Twister stream), so stego outputs stay bit-identical to the
    oracle while keeping global RNG state untouched.
    """
    idx = list(range(n))
    random.Random(seed).shuffle(idx)
    return idx
