"""codec_tcc_tpu_torch — the PyTorch/CUDA port of codec_tcc_tpu.

Reversible steganography for medical (DICOM) images on an NVIDIA Hopper GPU:
adaptive bit-plane decomposition, raster LSB embedding (``hybrid`` and
``multi_plane``, on the device or, as ``device_policy`` routes it, on the
host) and variance-ranked block embedding (``block_adaptive``) with XOR
location maps, prediction-error expansion
(``pee``, single images and batches in :mod:`.parallel.batch_pee`), the
STGC v2 container with the ``deflate`` transport codec, exact payload
extraction and original-image restoration; container batches
(:mod:`.parallel.batch`), STGV volumes (:mod:`.parallel.volume`),
capacity planning (``pipeline.capacity_report``), quality analysis
(:func:`analyze_pair`, :class:`QualityAnalyzer`) and the embedder models
(:func:`get_embedder`). Containers are byte-identical to the JAX package's
(``codec_tcc_tpu``), which stays in the repository as the reference.

The raster embed and extract and the PEE passes run as four hand-written
CUDA kernels (:mod:`.ops.raster_kernels`, :mod:`.ops.pee_kernels`). This
package imports torch and never jax.
"""

from .analyze import QualityAnalyzer
from .config import EncodeConfig
from .errors import CapacityError
from .models import get_embedder
from .pipeline import (
    DecodeResult,
    EncodeResult,
    analyze_pair,
    decode_container,
    decode_file,
    encode_array,
    encode_dicom,
)

__version__ = "0.1.0"

__all__ = [
    "CapacityError",
    "EncodeConfig",
    "EncodeResult",
    "DecodeResult",
    "QualityAnalyzer",
    "encode_array",
    "encode_dicom",
    "decode_container",
    "decode_file",
    "analyze_pair",
    "get_embedder",
    "__version__",
]
