# Port of codec_tcc_tpu/models/__init__.py.
"""Embedder model registry.

Each embedding strategy is a model class with a uniform ``encode`` /
``decode`` / ``capacity_bits`` surface (:mod:`.lsb`), selected by
:func:`get_embedder`; :mod:`.pee` holds the prediction-error-expansion
encoder and decoder the ``pee`` model runs.
"""

from .lsb import (
    BlockAdaptiveEmbedder,
    Embedder,
    HybridEmbedder,
    MultiPlaneEmbedder,
    PeeEmbedder,
    get_embedder,
)

__all__ = [
    "Embedder",
    "MultiPlaneEmbedder",
    "BlockAdaptiveEmbedder",
    "HybridEmbedder",
    "PeeEmbedder",
    "get_embedder",
]
