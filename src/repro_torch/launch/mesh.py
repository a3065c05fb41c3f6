"""Device meshes: a grid of ``torch.device`` with named axes.

The counterpart of ``jax.sharding.Mesh`` for the port's single-controller
sharding (``repro_torch.distributed``): one process holds every shard and
drives each on its own device, so a mesh is only the grid of devices and
the names of its axes.  Nothing here touches a device when it is imported.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """An ``np.ndarray`` of ``torch.device`` (``devices``) whose axes are
    named by ``axis_names``; ``shape`` maps each name to its size, as in
    ``jax.sharding.Mesh``."""

    devices: np.ndarray
    axis_names: Tuple[str, ...]

    def __post_init__(self):
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"a mesh of shape {self.devices.shape} needs "
                             f"{self.devices.ndim} axis names, got "
                             f"{self.axis_names}")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"axis names repeat: {self.axis_names}")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def coords(self):
        """Every mesh coordinate, in row-major order."""
        return list(np.ndindex(*self.devices.shape))

    def device(self, coord) -> torch.device:
        return self.devices[tuple(coord)]

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, devices="
                f"{[str(d) for d in self.devices.flat]})")


def _grid(devices: Sequence[torch.device], shape) -> np.ndarray:
    grid = np.empty(len(devices), dtype=object)
    grid[:] = list(devices)
    return grid.reshape(tuple(shape))


def make_host_mesh(model_axis: int = 1, *,
                   device: Optional[str] = None) -> Mesh:
    """Whatever this host has: the visible GPUs, (n // model_axis,
    model_axis) over ('data', 'model').  Raises where there is no GPU,
    unless the caller passes ``device="cpu"`` (one CPU device)."""
    if device is not None:
        if torch.device(device).type != "cpu":
            raise ValueError(f"make_host_mesh takes device='cpu' or none, "
                             f"got {device!r}")
        devices = [torch.device("cpu")]
    else:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise RuntimeError("make_host_mesh: this host has no GPU; pass "
                               "device='cpu' for a CPU mesh")
        devices = [torch.device("cuda", i) for i in range(n)]
    n = len(devices)
    if n % model_axis:
        raise ValueError(f"{n} device(s) do not split into a model axis of "
                         f"{model_axis}")
    return Mesh(_grid(devices, (n // model_axis, model_axis)),
                ("data", "model"))


def make_forced_host_mesh(shape, axes=("data", "model"),
                          device=None) -> Mesh:
    """A mesh of ``shape`` over ``axes``, the counterpart of XLA's forced
    host devices.

    With ``device`` given, every entry is that one device: virtual
    devices, so a one-card host (``"cuda:0"``) or the CPU (``"cpu"``) can
    run any mesh shape.  Without it, the first ``prod(shape)`` GPUs, and a
    ValueError where the host has fewer, as JAX raises.
    """
    shape = tuple(int(s) for s in shape)
    n = int(np.prod(shape))
    if device is not None:
        devices = [torch.device(device)] * n
    else:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n:
            raise ValueError(f"mesh shape {shape} needs {n} devices, "
                             f"host has {have}")
        devices = [torch.device("cuda", i) for i in range(n)]
    return Mesh(_grid(devices, shape), tuple(axes))
