"""Device meshes: a named grid of ``torch.device``s in one process.

The reference builds its meshes with ``jax.make_mesh`` over the runtime's
devices. The port drives every device from one process, as its sharded
engine does (ROADMAP conventions), so a mesh here is only a grid of
devices with an axis name for each dimension. ``torch.distributed``'s
``DeviceMesh`` is not used: it needs one process a rank, and NCCL refuses
two ranks on one card. A device may fill several positions of a grid, so
one card can hold a (2, 2) mesh: each position keeps its own blocks.

Single pod: (16, 16) = 256 chips, axes (data, model). Multi-pod: (2, 16, 16)
= 512, axes (pod, data, model); ``pod`` composes with ``data`` for batch
sharding or carries pipeline stages. ``make_production_mesh`` builds both on
the ``meta`` device, where only shapes and byte counts exist.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


class Mesh:
    """``devices``: an object array of ``torch.device``s, one a position,
    with one name in ``axis_names`` a dimension. ``shape`` maps each axis
    name to its size, in order (the reference's ``mesh.shape``)."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"a {devices.ndim}-d grid needs as many axis "
                             f"names, got {tuple(axis_names)}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"axis names repeat: {tuple(axis_names)}")
        self.devices = devices
        self.axis_names: Tuple[str, ...] = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def positions(self) -> List[Tuple[int, ...]]:
        """Every position of the grid, in row-major order."""
        return list(np.ndindex(*self.devices.shape))

    def axis_devices(self, axis: str) -> List[torch.device]:
        """The devices along ``axis`` at position 0 of every other axis:
        stage ``s`` of a pipeline or rank ``s`` of a reduction."""
        index = [0] * self.devices.ndim
        index[self.axis_names.index(axis)] = slice(None)
        return list(self.devices[tuple(index)])


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              devices: Union[DeviceLike, Sequence[DeviceLike]] = "cuda"
              ) -> Mesh:
    """A ``shape`` grid named ``axes``. ``devices`` is one device, which
    fills every position, or exactly one device a position, row-major."""
    shape = tuple(int(n) for n in shape)
    if isinstance(devices, (str, torch.device)):
        devices = [devices] * math.prod(shape)
    devices = [resolve_device(d) for d in devices]
    if len(devices) != math.prod(shape):
        raise ValueError(f"a {shape} mesh needs {math.prod(shape)} devices, "
                         f"got {len(devices)}")
    grid = np.empty(len(devices), dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(shape), axes)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production grids on the ``meta`` device."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, "meta")


def make_host_mesh(model_parallel: int = 1,
                   devices: Optional[Sequence[DeviceLike]] = None) -> Mesh:
    """(n / model_parallel, model_parallel) ``("data", "model")`` over
    ``devices``, by default every visible CUDA device."""
    if devices is None:
        resolve_device("cuda")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    n = len(devices)
    if n % model_parallel:
        raise ValueError(f"{n} devices do not split into model_parallel "
                         f"{model_parallel}")
    return make_mesh((n // model_parallel, model_parallel),
                     ("data", "model"), devices)
