# Copy of codec_tcc_tpu/utils/pool.py (host_workers).
"""Host-shell thread-pool sizing.

The container/codec host shell (zlib, container framing) is CPU-bound
numpy/zlib work, so pools are capped by the cores actually available
instead of the batch size alone.
"""

from __future__ import annotations

import os


def host_workers(n_items: int, cap: int = 8) -> int:
    """Worker count for a host-shell pool over ``n_items`` tasks: at most
    ``cap``, never more than items or available cores, always >= 1."""
    cores = os.cpu_count() or 1
    return max(1, min(cap, n_items, cores))
