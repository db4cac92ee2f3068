"""Batched pipelines: :mod:`.batch_pee` (PEE with per-image thresholds)."""
