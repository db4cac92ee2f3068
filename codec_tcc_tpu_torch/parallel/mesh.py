# Port of codec_tcc_tpu/parallel/mesh.py::make_mesh over explicit torch
# devices. batch_sharding, replicated and P (which no module of the package
# uses) and initialize_distributed (multi-host) are not ported: ROADMAP.md,
# queue 1 item 7 and item 10.
"""Device meshes: the ``dp`` and ``tile`` axes of the JAX package.

The JAX package lays its devices out as a ``jax.sharding.Mesh`` whose axes
are the two parallel dimensions of the workload: ``dp``, a batch of
independent images, and ``tile``, the rows of one large image
(:mod:`.tile`, :mod:`.tile_pee`). Here a :class:`Mesh` is an array of
``torch.device`` with the same axis names, ``shape`` and ``size``.

Execution is single-controller, as under ``shard_map``: one process holds
every shard's tensors on that shard's device and launches each shard's work
on its device (asynchronously, on the device's current stream). What
couples the shards is small: the halo rows and the rank prefix of
:mod:`.tile_pee` are copies of a row or a scalar between devices, and the
histogram and metric sums are reductions on the host. A device may appear
more than once (``make_mesh(devices=["cuda:0"] * 4)``): its shards then
share the card, as the JAX tests' virtual host devices share the CPU.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["Mesh", "make_mesh"]


class Mesh:
    """Devices laid out over named axes: ``devices`` is an object array of
    ``torch.device`` whose shape is the axes' sizes."""

    def __init__(self, devices: np.ndarray, axis_names: Tuple[str, ...]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"a {devices.ndim}-D device array needs as many "
                             f"axis names, got {axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def axis_devices(self, axis: str) -> List[torch.device]:
        """The devices along ``axis``, at index 0 of every other axis: the
        device of each shard of an array split over ``axis`` alone (its
        copies along the other axes would repeat the same work)."""
        if axis not in self.axis_names:
            raise ValueError(f"mesh axes {self.axis_names} have no {axis!r}")
        k = self.axis_names.index(axis)
        index = tuple(slice(None) if i == k else 0
                      for i in range(len(self.axis_names)))
        return list(self.devices[index])


def make_mesh(
    n_devices: Optional[int] = None,
    axes: Tuple[str, ...] = ("dp",),
    shape: Optional[Tuple[int, ...]] = None,
    *,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Build a mesh over the first ``n_devices`` devices.

    ``devices`` defaults to the visible CUDA devices; pass e.g.
    ``["cpu"] * 8`` or ``["cuda:0"] * 4`` to lay shards on chosen devices
    (repeats allowed). ``shape`` defaults to putting everything on the
    first axis; pass e.g. ``shape=(4, 2)`` with ``axes=("dp", "tile")`` for
    a 2-D layout."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if n_devices is None:
        n_devices = max(len(devices), 1)
    if n_devices > len(devices):
        raise ValueError(f"requested {n_devices} devices, have {len(devices)}")
    devs = np.empty(n_devices, dtype=object)
    for i in range(n_devices):
        devs[i] = devices[i]
    if shape is None:
        shape = (n_devices,) + (1,) * (len(axes) - 1)
    return Mesh(devs.reshape(shape), tuple(axes))
