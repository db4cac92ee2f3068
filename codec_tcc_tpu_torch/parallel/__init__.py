"""Batched pipelines: :mod:`.batch` (the raster and block batch and the
container-level batch encode/decode), :mod:`.batch_pee` (PEE with
per-image thresholds), :mod:`.runner` (per-item jobs with a
checkpointed manifest) and :mod:`.volume` (one payload across the slices
of a volume, the STGV file)."""
