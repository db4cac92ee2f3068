"""Batched and multi-device pipelines: :mod:`.batch` (the raster and block
batch and the container-level batch encode/decode), :mod:`.batch_pee` (PEE
with per-image thresholds), :mod:`.runner` (per-item jobs with a
checkpointed manifest), :mod:`.volume` (one payload across the slices of a
volume, the STGV file), :mod:`.mesh` (devices over named axes, the ``dp``
split of a batch and multi-host bring-up) and the ``tile`` axis of a mesh:
one large image's rows split across its devices, raster (:mod:`.tile`) and
PEE (:mod:`.tile_pee`)."""

from .mesh import Mesh, dp_shards, initialize_distributed, make_mesh
from .tile import decode_container_tiled, encode_array_tiled
from .tile_pee import decode_container_tiled_pee, encode_array_tiled_pee

__all__ = [
    "Mesh",
    "make_mesh",
    "dp_shards",
    "initialize_distributed",
    "encode_array_tiled",
    "decode_container_tiled",
    "encode_array_tiled_pee",
    "decode_container_tiled_pee",
]
