"""The search meshes: named device grids for batch- and index-axis
scale-out.

Counterpart of the search part of `repro/distributed/sharding.py`
(`INDEX_AXIS`, `search_mesh_2d`; the LM's logical-axis rules come with
the train launcher's mesh). The port's mesh is single-controller: one
Python process holds every position's tensors and runs each position's
search on its device, and the engines move pools between positions with
`.to(device)`. A mesh is an object ndarray of `torch.device` with one
name an axis:

  `SearchEngine`         a 1-D ("data",) mesh: the batch is cut into one
                         contiguous slice a position, the index is
                         replicated (`core.engine.make_search_mesh`);
  `ShardedSearchEngine`  a 2-D ("data", "index") mesh: the index axis
                         owns whole shards, the data axis cuts the batch
                         (`search_mesh_2d`).

Stated departure: a jax `Mesh` refuses a device listed twice; this one
takes it. An explicit mesh may repeat a device, so `[cpu] × 4` runs every
line of the mesh paths in the CPU tests and `[cuda:0] × 4` runs them on
one card with the same kernels; the positions then run one after
another. The index is placed once a distinct device, so a repeated
device holds one copy.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.distributed.fault_tolerance import best_search_mesh_shape

#: mesh axis the engines cut the query batch over
BATCH_AXIS = "data"
#: mesh axis the sharded engine partitions the index over (whole shards a
#: position); composes with the batch axis as a 2-D search mesh
INDEX_AXIS = "index"


def canonical_device(device) -> torch.device:
    """`device` as a torch.device with its index ("cuda" → "cuda:<current>"),
    so that two names of one card compare equal."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def visible_devices() -> list:
    """The visible cards, each once (none on a host without CUDA)."""
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


class Mesh:
    """An object ndarray of `torch.device` with named axes.

    `shape` maps axis names to sizes in axis order, `size` counts
    positions; a device may be listed more than once (the stated
    departure of this module's docstring)."""

    def __init__(self, devices, axis_names):
        src = np.asarray(devices, dtype=object)
        arr = np.empty(src.shape, dtype=object)
        for i, d in np.ndenumerate(src):
            arr[i] = canonical_device(d)
        names = tuple(axis_names)
        if arr.ndim != len(names) or len(set(names)) != len(names):
            raise ValueError(f"a mesh of shape {arr.shape} needs "
                             f"{arr.ndim} distinct axis names, got {names}")
        if arr.size == 0:
            raise ValueError("a mesh needs at least one device")
        self.devices = arr
        self.axis_names = names

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def first(self) -> torch.device:
        """The first position's device: where an engine's results land."""
        return self.devices.flat[0]

    @property
    def distinct(self) -> list:
        """The distinct devices in position order."""
        out = []
        for d in self.devices.flat:
            if d not in out:
                out.append(d)
        return out

    def grid(self, *names) -> np.ndarray:
        """The devices with axes `names` in that order; every other axis
        at its first position (a replica along it would compute the same
        values)."""
        missing = [a for a in names if a not in self.axis_names]
        if missing:
            raise ValueError(f"mesh axes {self.axis_names} lack {missing}")
        idx = tuple(slice(None) if a in names else 0
                    for a in self.axis_names)
        kept = [a for a in self.axis_names if a in names]
        return np.transpose(self.devices[idx],
                            [kept.index(a) for a in names])

    def __repr__(self) -> str:
        return (f"Mesh({dict(self.shape)}, "
                f"devices={[str(d) for d in self.devices.flat]})")


def search_mesh_2d(n_shards: int, devices=None) -> Mesh | None:
    """2-D ("data", "index") mesh for index-axis-sharded search.

    The index axis gets the largest device count that divides both the
    devices and `n_shards` (each index position then owns n_shards/index
    whole shards); the rest of the devices cut the batch
    (`fault_tolerance.best_search_mesh_shape`). `devices` defaults to the
    visible cards, each once; an explicit list may repeat a device.
    Returns None on a single device — the sharded engine's loop path
    needs no mesh."""
    devices = visible_devices() if devices is None else list(devices)
    if len(devices) <= 1:
        return None
    shape, names = best_search_mesh_shape(len(devices), n_shards)
    n_used = int(np.prod(shape))
    arr = np.empty(n_used, dtype=object)
    arr[:] = devices[:n_used]
    return Mesh(arr.reshape(shape), names)
