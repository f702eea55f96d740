"""Host meshes (port of the JAX package's `launch/mesh.py`).

A `Mesh` is a grid of devices with one name a grid axis, as
`jax.sharding.Mesh` is: the sharding rules (`parallel/sharding.py`) read
only its `axis_names` and `devices.shape`. `make_host_mesh` covers the
devices that exist: every visible CUDA device, or one CPU device when the
caller asks for the CPU. The production meshes of 256 and 512 chips
(`make_production_mesh`) are not ported.
"""
from __future__ import annotations

import dataclasses
from typing import Union

import numpy as np
import torch

from ..device import resolve_device


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """`devices`: an ndarray of `torch.device`, one axis a name of
    `axis_names`."""

    devices: np.ndarray
    axis_names: tuple

    def __post_init__(self):
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"mesh of shape {self.devices.shape} needs "
                             f"{self.devices.ndim} axis names, got "
                             f"{self.axis_names}")

    @property
    def shape(self) -> dict:
        """Axis name → size, as `jax.sharding.Mesh.shape`."""
        return dict(zip(self.axis_names, self.devices.shape))


def make_host_mesh(model: int = 1,
                   device: Union[str, torch.device, None] = None) -> Mesh:
    """A ("data", "model") mesh over every visible CUDA device (`device`
    None or a CUDA device; raises if there is none), or over the one CPU
    device (`device="cpu"`); the "model" axis takes min(model, devices)."""
    device = resolve_device(device)
    if device.type == "cuda":
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    else:
        devs = [device]
    n = len(devs)
    model = min(model, n)
    if model < 1 or n % model:
        raise ValueError(f"a model axis of {model} does not divide "
                         f"{n} devices")
    grid = np.empty(n, dtype=object)
    grid[:] = devs
    return Mesh(grid.reshape(n // model, model), ("data", "model"))
