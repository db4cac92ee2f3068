"""How an array reaches the device and comes back: the one place that
resolves a caller's ``device``, uploads numpy arrays to it and downloads
tensors from it.

Every entry point of the package takes ``device`` (default ``"cuda"``) and
passes it through :func:`resolve_device`, which never picks a device itself:
``"cuda"`` without a usable GPU raises instead of running on the CPU.

Every copy between the host and a CUDA device goes through :func:`upload`,
:func:`upload_bytes`, :func:`to_device` or :func:`download`, which count its
bytes in
``profiling``'s ``h2d_bytes`` and ``d2h_bytes`` and in the innermost open
span. A CPU tensor counts nothing, and neither does a copy between devices.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

from . import profiling

__all__ = ["DeviceLike", "resolve_device", "upload", "upload_bytes",
           "to_device", "download"]

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


def upload(arr: np.ndarray, dev: torch.device, *,
           pinned: bool = False) -> torch.Tensor:
    """numpy -> tensor on ``dev``; copies first when the array is read-only
    (``np.frombuffer`` results), which ``torch.from_numpy`` must not wrap.
    ``pinned`` stages the array in pinned memory and queues the copy on
    the current stream without waiting for it."""
    if not (arr.flags.writeable and arr.flags.c_contiguous):
        arr = np.array(arr, order="C", copy=True)
    t = torch.from_numpy(arr)
    if torch.device(dev).type != "cuda":
        return t.to(dev)
    profiling.copied("h2d_bytes", arr.nbytes)
    if pinned:
        return t.pin_memory().to(dev, non_blocking=True)
    return t.to(dev)


def upload_bytes(data, dev: torch.device, nbytes: int) -> torch.Tensor:
    """A bytes-like ``data`` as a uint8 tensor of ``nbytes`` on ``dev`` (zeros
    after ``data``), written once into pinned memory and copied on the
    current stream without waiting."""
    src = np.frombuffer(data, np.uint8)
    cuda = torch.device(dev).type == "cuda"
    host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=cuda)
    view = host.numpy()
    view[:src.size] = src
    view[src.size:] = 0
    if not cuda:
        return host.to(dev)
    profiling.copied("h2d_bytes", nbytes)
    return host.to(dev, non_blocking=True)


def to_device(arr, dev: torch.device) -> torch.Tensor:
    """An array as a tensor on ``dev``: tensors move there, anything else
    goes through ``np.asarray`` and uploads."""
    if not isinstance(arr, torch.Tensor):
        return upload(np.asarray(arr), dev)
    dev = torch.device(dev)
    if arr.device.type != dev.type:
        nbytes = arr.numel() * arr.element_size()
        profiling.copied("h2d_bytes" if dev.type == "cuda" else "d2h_bytes",
                         nbytes)
    return arr.to(dev)


def download(t: torch.Tensor) -> np.ndarray:
    """A tensor's values on the host, as numpy."""
    if t.device.type == "cuda":
        profiling.copied("d2h_bytes", t.numel() * t.element_size())
    return t.cpu().numpy()
