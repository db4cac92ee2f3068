# Port of codec_tcc_tpu/parallel/mesh.py: make_mesh over explicit torch
# devices, initialize_distributed over torch.distributed, and the `dp` split
# that the JAX package's NamedSharding(mesh, P("dp", ...)) makes
# (dp_shards). batch_sharding, replicated and P (which no module of the
# package uses) are not ported: ROADMAP.md, queue 1 item 10.
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

A batch splits over the ``dp`` axis in contiguous equal shards
(:func:`dp_shards`), as ``P("dp")`` lays it out; each shard's work runs
under :func:`device_guard`, so that a kernel launched through the kernel
library lands on the shard's card and not on the current one. Across
processes (:func:`initialize_distributed`) each process holds a mesh of
its own devices and takes its contiguous part of the global batch.
"""

from __future__ import annotations

import contextlib
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["Mesh", "make_mesh", "dp_devices", "dp_shards", "lead_device",
           "device_guard", "initialize_distributed"]


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


def dp_devices(mesh: Mesh) -> List[torch.device]:
    """The devices of ``mesh``'s ``dp`` axis (:meth:`Mesh.axis_devices`); a
    mesh without one has ``dp`` size 1, its first device."""
    if "dp" in mesh.axis_names:
        return mesh.axis_devices("dp")
    return [mesh.devices.flat[0]]


def dp_shards(
    b: int,
    mesh: Optional[Mesh],
    device="cuda",
    *,
    uneven: str = "raise",
    rows: Optional[int] = None,
) -> List[Tuple[torch.device, slice]]:
    """A batch of ``b`` items split over ``mesh``'s ``dp`` axis: the list of
    ``(device, slice)`` shards, in batch order.

    Without a mesh, one shard of every item on ``device``. With one, the
    ``dp`` devices take ``rows // dp`` consecutive items each, as
    ``NamedSharding(mesh, P("dp"))`` lays out the leading axis; ``device``
    is not used. ``rows`` (default ``b``) is the size the split is made
    for: a PEE attempt group splits as its power-of-two padding would,
    and its last shards are shorter or empty, since no pad item is made.
    Where ``rows`` is not a multiple of the ``dp`` size, ``uneven="raise"``
    raises ``ValueError`` (where the JAX package's ``device_put`` raises)
    and ``uneven="single"`` gives one shard of every item on the first
    ``dp`` device (where the JAX package runs unsharded)."""
    if mesh is None:
        return [(resolve_device(device), slice(0, b))]
    devices = [resolve_device(d) for d in dp_devices(mesh)]
    rows = b if rows is None else rows
    if rows % len(devices):
        if uneven == "single":
            return [(devices[0], slice(0, b))]
        raise ValueError(
            f"a batch of {rows} does not split evenly over the mesh's dp "
            f"axis of {len(devices)} devices"
        )
    k = rows // len(devices)
    return [(dev, slice(min(i * k, b), min((i + 1) * k, b)))
            for i, dev in enumerate(devices)]


def lead_device(mesh: Optional[Mesh], device="cuda") -> torch.device:
    """Where work the JAX package runs unsharded goes: the first ``dp``
    device of ``mesh``, or ``device`` without a mesh."""
    return resolve_device(device if mesh is None else dp_devices(mesh)[0])


def device_guard(dev: torch.device):
    """``torch.cuda.device(dev)`` for a CUDA device, else a no-op: the
    kernel library launches on the CUDA runtime's current device, so each
    shard's launches run with its own card current."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Multi-host bring-up over ``torch.distributed``: a ``gloo`` process
    group at ``tcp://{coordinator_address}`` of ``num_processes`` ranks,
    this one ``process_id``. Without an address it uses ``env://`` where
    ``MASTER_ADDR`` and ``WORLD_SIZE`` are set. A no-op when a process
    group already exists or no world is given (the JAX version's no-op when
    already initialized or single-process).

    What crosses processes is small and on the host: the 65,536-bin value
    histogram of each process's shard and a few scalars, hence ``gloo``.
    NCCL would refuse two ranks on one GPU, so it cannot be exercised on a
    one-card machine. Each process then builds a mesh of its own devices
    (:func:`make_mesh`) and takes the contiguous part
    ``[rank * k, (rank + 1) * k)`` of a global batch of ``k`` items per
    process: the split of the JAX package's global ``P("dp")`` over
    process-major devices."""
    import torch.distributed as dist

    if dist.is_initialized():
        return
    if coordinator_address is None:
        if not (os.environ.get("MASTER_ADDR")
                and os.environ.get("WORLD_SIZE")):
            return
        init_method = "env://"
    else:
        init_method = f"tcp://{coordinator_address}"
    dist.init_process_group(
        "gloo", init_method=init_method,
        world_size=-1 if num_processes is None else num_processes,
        rank=-1 if process_id is None else process_id,
    )
