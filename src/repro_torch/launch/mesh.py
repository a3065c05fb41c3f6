"""Device meshes: a grid of ``torch.device`` with named axes.

The counterpart of ``jax.sharding.Mesh`` for the port's single-controller
sharding (``repro_torch.distributed``): one process holds every shard and
drives each on its own device, so a mesh is only the grid of devices and
the names of its axes.  Nothing here touches a device when it is imported.

The per-card peaks below (NVIDIA's H100 SXM data sheet, 700 W, dense) are
the roofline denominators of the dry run (``launch/dryrun.py``) and the
cost model's (``api/costmodel.py``), which imports them from here.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch


# H100 SXM, per card (NVIDIA data sheet, 700 W, dense): the roofline
# denominators.  The JAX package's ICI_BW (one TPU link) has no
# counterpart: a copy between coordinates crosses NVLink when it crosses
# only 'model' (one HGX host's eight cards) and the network otherwise.
CARD = "NVIDIA H100 80GB HBM3, 700 W, data sheet"
HBM_BYTES = 80e9                  # device memory
PEAK_BF16_FLOPS = 989e12          # bf16 tensor-core FLOP/s
PEAK_INT8_OPS = 1979e12           # int8 tensor-core operations / s
PEAK_F32_OPS = 67e12              # f32 operations / s outside the tensor cores
HBM_BW = 3.35e12                  # HBM bytes / s
NVLINK_BW = 450e9                 # NVLink bytes / s, each way
NET_BW = 50e9                     # one 400 Gb/s NDR port a card, bytes / s


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """An ``np.ndarray`` of ``torch.device`` (``devices``) whose axes are
    named by ``axis_names``; ``shape`` maps each name to its size, as in
    ``jax.sharding.Mesh``."""

    devices: np.ndarray
    axis_names: Tuple[str, ...]
    one_card: bool = False

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

    def home(self, coord):
        """What holds coordinate ``coord``'s memory: its device, or on a
        mesh of meta devices (the dry run's virtual cards) the coordinate
        itself, so that every coordinate holds its own blocks, unless the
        mesh stands for one card (``one_card``: a mesh that repeats one
        device, as a one-card host runs any mesh shape)."""
        d = self.devices[tuple(coord)]
        if d.type == "meta" and not self.one_card:
            return ("meta", tuple(coord))
        return d

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
                          device=None, one_card: bool = False) -> Mesh:
    """A mesh of ``shape`` over ``axes``, the counterpart of XLA's forced
    host devices.

    With ``device`` given, every entry is that one device: virtual
    devices, so a one-card host (``"cuda:0"``) or the CPU (``"cpu"``) can
    run any mesh shape.  Without it, the first ``prod(shape)`` GPUs, and a
    ValueError where the host has fewer, as JAX raises.  A mesh of meta
    devices is the dry run's: each coordinate a card of its own, or with
    ``one_card`` all of them one card, as ``device="cuda:0"`` lays a
    mesh out on a one-card host.
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
    return Mesh(_grid(devices, shape), tuple(axes), one_card)


def make_production_mesh(*, multi_pod: bool = False,
                         device: Optional[str] = None) -> Mesh:
    """The production mesh of H100s: (32, 8) over ('data', 'model'), 256
    cards, or with ``multi_pod`` (2, 32, 8) over ('pod', 'data', 'model'),
    512: the JAX package's card counts (a 16x16 or 2x16x16 TPU v5e mesh).

    Eight on 'model' because an HGX H100 host joins its eight cards by
    NVLink (450 GB/s each way): tensor and expert parallelism stay inside
    that domain, and 'data' and 'pod' cross hosts over the network.  A
    16-way 'model' axis, the JAX shape, would put tensor parallelism on
    the network, which no H100 deployment does.

    With ``device="meta"`` every coordinate is a virtual device (the dry
    run's, ``launch/dryrun.py``); without it the mesh needs that many
    visible GPUs and raises a ValueError otherwise, as ``jax.make_mesh``
    raises.
    """
    shape = (2, 32, 8) if multi_pod else (32, 8)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if device is not None and torch.device(device).type != "meta":
        raise ValueError(f"make_production_mesh takes device='meta' or "
                         f"none, got {device!r}")
    return make_forced_host_mesh(shape, axes, device=device)
