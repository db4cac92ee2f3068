"""What the entries share: the port's encode configuration from a
configuration file."""

from __future__ import annotations

# The configuration file's keys that are ``EncodeConfig`` fields.
ENCODE_KEYS = ("strategy", "beta", "codec", "seed", "search_block_size",
               "align_across_planes", "pee_threshold", "compute_metrics",
               "device_policy", "container_version")


def encode_config(cfg: dict):
    from codec_tcc_tpu_torch import EncodeConfig

    return EncodeConfig(**{k: cfg[k] for k in ENCODE_KEYS if k in cfg})
