"""Batched pipelines: :mod:`.batch_pee` (PEE with per-image thresholds) and
:mod:`.batch` (the host hybrid start scan the raster encoders share)."""
