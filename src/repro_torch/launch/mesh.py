"""Device meshes of the port (``repro/launch/mesh.py``).

A mesh is a small record: axis names, and a numpy array of
``torch.device`` whose shape is the mesh's. The port runs one process
(the reference's single controller): each shard of a mesh is a tensor on
its listed device, and shards may repeat one device, as they do on a
host with one card, where every shard of a serving mesh lives on
``cuda:0`` and stands in for one device's HBM. The collectives over a
mesh (``distributed/collectives.py``) move data between the shards'
devices; a multi-process mesh across cards is not ported.

Devices come from the ``device`` argument, a device or a list of them,
through ``repro_torch.device.resolve``: ``cuda`` unless the caller asks
for ``cpu``, never a fallback. Like the reference, makers are functions,
so importing this module touches no device.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from repro_torch import device as devmod


class Mesh:
    """``axis_names`` (tuple of str), ``devices`` (numpy array of
    ``torch.device``, one entry per shard) and ``shape`` ({axis: size},
    in axis order, as the reference's ``mesh.shape``)."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        devices = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if devices.ndim != len(axis_names):
            raise ValueError(f"mesh of {devices.ndim} dims named "
                             f"{axis_names}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"mesh axis names repeat: {axis_names}")
        self.devices = devices
        self.axis_names = axis_names

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def axis_devices(self, axis: str) -> Tuple[torch.device, ...]:
        """The devices along ``axis`` (index 0 on every other axis): the
        shards a one-axis ``shard_map`` runs on, in shard order."""
        i = self.axis_names.index(axis)
        idx = [0] * self.devices.ndim
        idx[i] = slice(None)
        return tuple(self.devices[tuple(idx)])

    def __repr__(self):
        devs = sorted(set(map(str, self.devices.flat)))
        return f"Mesh({self.shape}, devices={devs})"


def _devices(n: int, device) -> list:
    """``n`` devices: a single device (str or ``torch.device``) repeated,
    or the first ``n`` of a list."""
    if device is None or isinstance(device, (str, torch.device)):
        return [devmod.resolve("cuda" if device is None else device)] * n
    devs = [devmod.resolve(d) for d in device]
    if len(devs) < n:
        raise ValueError(f"mesh of {n} shards but {len(devs)} devices")
    return devs[:n]


def _mesh(shape, axes, device) -> Mesh:
    n = int(np.prod(shape))
    arr = np.empty(n, dtype=object)
    arr[:] = _devices(n, device)
    return Mesh(arr.reshape(tuple(shape)), axes)


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """The reference's production layout, (data 16, model 16) or (pod 2,
    data 16, model 16)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device)


def make_debug_mesh(shape=(2, 4), axes=("data", "model"), device=None) \
        -> Mesh:
    return _mesh(shape, axes, device)


def make_serving_mesh(n: int = None, axis: str = "heads",
                      device=None) -> Mesh:
    """1-D tensor-parallel mesh for the serving engine's ``sharded``
    attention backend: every shard holds a head slice of q/k/v and of
    the KVPool arenas. ``n`` defaults to the number of devices listed,
    or to every visible card for a single ``cuda`` device."""
    if n is None:
        if device is not None and not isinstance(device, (str, torch.device)):
            n = len(device)
        else:
            dev = devmod.resolve("cuda" if device is None else device)
            n = torch.cuda.device_count() if dev.type == "cuda" else 1
            device = list(range(n)) if dev.type == "cuda" and n > 1 \
                else dev
    return _mesh((n,), (axis,), device)


def data_axes(mesh: Mesh):
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def dp_size(mesh: Mesh) -> int:
    return int(np.prod([mesh.shape[a] for a in data_axes(mesh)]))
