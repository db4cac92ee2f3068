"""How an array reaches the device: the one place that resolves a caller's
``device`` and uploads numpy arrays to it.

Every entry point of the package takes ``device`` (default ``"cuda"``) and
passes it through :func:`resolve_device`, which never picks a device itself:
``"cuda"`` without a usable GPU raises instead of running on the CPU.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

__all__ = ["DeviceLike", "resolve_device", "upload", "to_device"]

DeviceLike = Union[torch.device, str]


def resolve_device(device: DeviceLike) -> torch.device:
    """The device a caller asked for. Never picks one itself: ``"cuda"``
    without a usable GPU raises instead of running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run the plain torch versions"
            )
    elif dev.type != "cpu":
        raise ValueError(f"device must be cuda or cpu, not {dev}")
    return dev


def upload(arr: np.ndarray, dev: torch.device) -> torch.Tensor:
    """numpy -> tensor on ``dev``; copies first when the array is read-only
    (``np.frombuffer`` results), which ``torch.from_numpy`` must not wrap."""
    if not (arr.flags.writeable and arr.flags.c_contiguous):
        arr = np.array(arr, order="C", copy=True)
    return torch.from_numpy(arr).to(dev)


def to_device(arr, dev: torch.device) -> torch.Tensor:
    """An array as a tensor on ``dev``: tensors move there, anything else
    goes through ``np.asarray`` and uploads."""
    if isinstance(arr, torch.Tensor):
        return arr.to(dev)
    return upload(np.asarray(arr), dev)
