# Port of codec_tcc_tpu/config.py: the same code; only import lines and prose differ.
"""Configuration for the encode/decode/analyze pipelines.

The reference has no config system — every knob is hardcoded in ``main()``
(``src/codec.py:847-926``: input path, message, beta=0.4,
strategy, block size, codec='jxl', output path; SURVEY §5 "config/flag
system: absent"). This dataclass + the CLI in :mod:`codec_tcc_tpu.cli` expose
every knob the survey identifies: beta, nbits / BitsStored override, strategy,
block sizes, alignment, codec, seed.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

from .utils.rng import DEFAULT_SEGMENT_SHUFFLE_SEED

STRATEGIES = ("multi_plane", "block_adaptive", "hybrid", "pee")


@dataclass(frozen=True)
class EncodeConfig:
    # decomposition (src/codec.py:561-599)
    beta: float = 0.4
    nbits: Optional[int] = None        # None -> dtype width (reference default)
    use_bits_stored: bool = True       # fix for defect B6: honor DICOM BitsStored
    # embedding strategy (src/codec.py:276-487)
    strategy: str = "hybrid"
    block_size: int = 8                # block-adaptive tile size
    search_block_size: int = 16        # hybrid start-block search size
    align_across_planes: bool = False
    seed: int = DEFAULT_SEGMENT_SHUFFLE_SEED
    # PEE parameters (north-star scheme; see ops/pee.py)
    pee_threshold: int = 2
    # transport codec (src/codec.py:108-209)
    codec: str = "deflate"
    # capacity policy: by default, payloads the plan cannot fully embed are
    # rejected loudly; True reproduces the reference's silent per-plane clamp
    # (num_bits = min(len, h*w), src/codec.py:294) and drops overflow bits
    allow_capacity_overflow: bool = False
    # container
    store_bitmaps: bool = True
    container_version: int = 2
    # reporting
    compute_metrics: bool = True
    # where the batch raster embed runs (round 5). The raster strategies'
    # device work is O(payload) bit placement: on a single-host serving box
    # the image upload + packed-map download cost orders of magnitude more
    # link time than the same placement costs as host window work
    # (ops.host_embed), while PEE / block_adaptive / metrics / multi-device
    # meshes do real per-pixel device compute and keep the chip. "auto"
    # routes raster batches host-side exactly when that wins (raster
    # strategy, bit-packable geometry, no device metrics, no multi-device
    # mesh); "device" / "host" force a side (bench legs pin "device" so the
    # artifact still measures the chip route).
    device_policy: str = "auto"

    def resolve_host_route(self, n_pixels: int, n_devices: int = 1) -> bool:
        """THE device-policy routing decision — shared by the single-image
        pipeline and the batch encoder so the same config can never route
        differently between them. Raises for a forced ``host`` policy the
        window form cannot serve. ``n_devices`` > 1 (a real mesh) keeps the
        sharded device route under ``auto``."""
        host_ok = (
            self.strategy in ("multi_plane", "hybrid") and n_pixels % 8 == 0
        )
        if self.device_policy == "host":
            if not host_ok:
                raise ValueError(
                    "device_policy='host' needs a raster strategy "
                    "(multi_plane/hybrid) and H*W % 8 == 0; use 'auto' "
                    "or 'device'"
                )
            return True
        return (
            self.device_policy == "auto"
            and host_ok
            and not self.compute_metrics
            and n_devices <= 1
        )

    def validate(self) -> "EncodeConfig":
        if self.strategy not in STRATEGIES:
            raise ValueError(f"strategy must be one of {STRATEGIES}")
        if self.device_policy not in ("auto", "device", "host"):
            raise ValueError("device_policy must be auto, device, or host")
        if not (0.0 < self.beta <= 1.0):
            raise ValueError("beta must be in (0, 1]")
        if self.block_size < 1 or self.search_block_size < 1:
            raise ValueError("block sizes must be >= 1")
        if self.container_version not in (1, 2):
            raise ValueError("container_version must be 1 or 2")
        if self.container_version == 1 and self.strategy in (
            "block_adaptive", "pee",
        ):
            # the v1 header has no strategy/ext fields, so decode cannot
            # learn the block plan (block_adaptive) or the PEE boundaries:
            # the container would decode to garbage with no error
            raise ValueError(
                f"strategy {self.strategy!r} cannot round-trip through a v1 "
                "container (the v1 header records no strategy); use "
                "container_version=2"
            )
        return self

    def with_overrides(self, **kwargs) -> "EncodeConfig":
        return replace(self, **kwargs).validate()
