# Port of codec_tcc_tpu/errors.py: the same code; only import lines and prose differ.
"""Shared exception types.

``CapacityError`` distinguishes "the payload genuinely does not fit" from
other ``ValueError``s (bad codec name, malformed config, invalid shapes), so
callers that escalate thresholds — e.g. the volume PEE encoder re-splitting
at a larger T — can retry on capacity exhaustion without swallowing
unrelated validation failures (advisor finding, round 2).
"""


class CapacityError(ValueError):
    """Payload exceeds the embedding capacity of the target image(s)."""
