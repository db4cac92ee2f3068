"""Embedder models: :mod:`.pee` (prediction-error expansion)."""
