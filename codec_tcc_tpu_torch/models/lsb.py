# Port of codec_tcc_tpu/models/lsb.py. The same code but for the device
# each model takes and passes on, except Embedder.capacity_bits, whose
# histogram runs on that device.
"""Embedder model classes over the strategy pipelines.

Uniform facade: ``Embedder(device=..., **config_overrides).encode(image,
payload)`` / ``.decode(container)`` / ``.capacity_bits(image)``. The work
stays in :mod:`codec_tcc_tpu_torch.pipeline`; these classes pin the
strategy and carry the per-strategy knobs (block sizes, alignment, PEE
threshold) and the device (default ``"cuda"``).
"""

from __future__ import annotations

from typing import Dict, Optional, Type, Union

import numpy as np

from ..config import EncodeConfig
from ..io import container as container_io


class Embedder:
    """Base model: a strategy plus its configuration."""

    strategy: str = ""

    def __init__(self, *, device="cuda", **overrides):
        self.device = device
        self.config = EncodeConfig(strategy=self.strategy).with_overrides(**overrides)

    def encode(
        self,
        image: np.ndarray,
        payload: Union[bytes, str, np.ndarray],
        *,
        bits_stored: Optional[int] = None,
    ):
        from .. import pipeline

        return pipeline.encode_array(image, payload, self.config,
                                     bits_stored=bits_stored,
                                     device=self.device)

    def encode_dicom(self, path: str, payload: Union[bytes, str, np.ndarray]):
        from .. import pipeline

        return pipeline.encode_dicom(path, payload, self.config,
                                     device=self.device)

    def decode(self, container: Union[bytes, container_io.Container]):
        from .. import pipeline

        return pipeline.decode_container(container, device=self.device)

    def capacity_bits(self, image: np.ndarray, *, bits_stored: Optional[int] = None) -> int:
        """Payload capacity for this strategy on this image (the histogram
        on the model's device)."""
        from ..ops import decompose as decompose_ops
        from ..device import resolve_device, upload

        image = np.asarray(image)
        nbits = self.config.nbits
        if nbits is None:
            dtype_bits = image.dtype.itemsize * 8
            nbits = (
                bits_stored
                if (self.config.use_bits_stored and bits_stored)
                else dtype_bits
            )
        dec = decompose_ops.decompose(
            upload(image, resolve_device(self.device)),
            beta=self.config.beta, nbits=nbits,
        )
        # NOT the reference's s*H*W rule (codec.py:294): the quadratic
        # distribution oversubscribes plane 0, so the usable payload is
        # smaller; report the boundary the encoder accepts
        from ..ops.segments import usable_capacity_bits

        return usable_capacity_bits(dec.s, image.size, self.config.seed)


class MultiPlaneEmbedder(Embedder):
    """Strategy 1: raster LSB substitution (src/codec.py:276-318)."""

    strategy = "multi_plane"


class BlockAdaptiveEmbedder(Embedder):
    """Strategy 2, intended semantics (defect B2 fixed): variance-ranked
    block fill (src/codec.py:320-410)."""

    strategy = "block_adaptive"


class HybridEmbedder(Embedder):
    """Strategy 3 (the reference demo's default, src/codec.py:874):
    max-variance start block + raster wraparound (src/codec.py:412-487),
    with the chosen offset persisted (defect B4 fixed)."""

    strategy = "hybrid"


class PeeEmbedder(Embedder):
    """Prediction-error-expansion model (kernels K3/K4)."""

    strategy = "pee"

    def capacity_bits(self, image: np.ndarray, *, bits_stored: Optional[int] = None) -> int:
        """Achievable two-pass capacity at the configured threshold.

        Runs the saturated probe (pass-0 embed through K3, then pass-1
        capacity measured on the pass-0 RESULT): pass-0 expansions perturb
        the cross pixels pass 1 predicts from, so summing both passes'
        capacities on the pristine image would overestimate and advertise a
        capacity the encoder then rejects."""
        from ..parallel.batch_pee import probe_capacity_batch

        image = np.asarray(image)
        dtype_bits = image.dtype.itemsize * 8
        eff = bits_stored if (self.config.use_bits_stored and bits_stored) else dtype_bits
        max_val = (1 << eff) - 1
        if int(image.max()) > max_val:
            max_val = (1 << dtype_bits) - 1
        t = max(1, self.config.pee_threshold)
        return int(probe_capacity_batch(image[None], t, max_val,
                                        device=self.device)[0])


_REGISTRY: Dict[str, Type[Embedder]] = {
    cls.strategy: cls
    for cls in (MultiPlaneEmbedder, BlockAdaptiveEmbedder, HybridEmbedder, PeeEmbedder)
}


def get_embedder(strategy: str, **overrides) -> Embedder:
    try:
        cls = _REGISTRY[strategy]
    except KeyError:
        raise ValueError(
            f"Unknown strategy '{strategy}' (have: {sorted(_REGISTRY)})"
        ) from None
    return cls(**overrides)
