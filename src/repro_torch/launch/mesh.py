"""Meshes (port of the JAX package's `launch/mesh.py`).

A `Mesh` is a grid of devices with one name a grid axis, as
`jax.sharding.Mesh` is: the sharding rules (`parallel/sharding.py`) read
only its `axis_names` and `devices.shape`. Three functions build one:

  make_host_mesh(model)       every visible CUDA device, or the one CPU
                              device when the caller asks for the CPU, in
                              this process (no process group);
  make_dist_mesh(shape, axes) one device a rank over the running process
                              group (`torchrun`, or a group the caller
                              initialised): the mesh carries a torch
                              `DeviceMesh`, and tensors are placed on it
                              by their logical specs (DTensor);
  make_production_mesh()      the (16, 16) ("data", "model") mesh, or the
                              (2, 16, 16) one with a leading "pod" axis,
                              over placeholder meta devices, for the
                              dry-run's per-device sizes.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional, Union

import numpy as np
import torch

from ..device import resolve_device


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """`devices`: an ndarray of `torch.device`, one axis a name of
    `axis_names`; `device_mesh`: the torch `DeviceMesh` over the process
    group when the mesh spans ranks (`make_dist_mesh`), else None."""

    devices: np.ndarray
    axis_names: tuple
    device_mesh: Optional[object] = None

    def __post_init__(self):
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"mesh of shape {self.devices.shape} needs "
                             f"{self.devices.ndim} axis names, got "
                             f"{self.axis_names}")

    @property
    def shape(self) -> dict:
        """Axis name → size, as `jax.sharding.Mesh.shape`."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def local_device(self) -> torch.device:
        """This rank's device (the first device for a mesh without a
        process group)."""
        if self.device_mesh is None:
            return self.devices.flat[0]
        return self.devices.flat[torch.distributed.get_rank()]


def _grid(devs: list, shape: tuple) -> np.ndarray:
    grid = np.empty(len(devs), dtype=object)
    grid[:] = devs
    return grid.reshape(shape)


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
    return Mesh(_grid(devs, (n // model, model)), ("data", "model"))


def make_dist_mesh(shape: tuple, axes: tuple,
                   device: Union[str, torch.device, None] = None) -> Mesh:
    """A mesh of `shape` over the ranks of the default process group, one
    device a rank: CUDA device LOCAL_RANK with `nccl` unless the caller
    asks for the CPU (`device="cpu"`), where every rank runs on `gloo`.
    Initialises the group from the environment (`torchrun`) when none is
    running; the world size must equal the mesh size."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    device = resolve_device(device)
    shape, axes = tuple(shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} needs {len(shape)} axis "
                         f"names, got {axes}")
    if device.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", 0))
        torch.cuda.set_device(local)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    backend = dist.get_backend()
    if (device.type == "cuda") != (backend == "nccl"):
        raise ValueError(f"a {device.type} mesh on a {backend!r} process "
                         f"group: CUDA meshes run on nccl, CPU ones on gloo")
    world = dist.get_world_size()
    if int(np.prod(shape)) != world:
        raise ValueError(f"a mesh of {shape} needs {int(np.prod(shape))} "
                         f"ranks; the process group has {world}")
    dm = init_device_mesh(device.type, shape, mesh_dim_names=axes)
    if device.type == "cuda":
        n_local = torch.cuda.device_count()
        devs = [torch.device("cuda", r % n_local) for r in range(world)]
        devs[dist.get_rank()] = torch.device("cuda",
                                             torch.cuda.current_device())
    else:
        devs = [torch.device("cpu")] * world
    return Mesh(_grid(devs, shape), axes, dm)


def make_production_mesh(multi_pod: bool = False) -> Mesh:
    """The (16, 16) ("data", "model") mesh of 256 devices, or (2, 16, 16)
    ("pod", "data", "model") of 512, over placeholder meta devices: no
    process group, for the dry-run's per-device sizes."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = int(np.prod(shape))
    return Mesh(_grid([torch.device("meta")] * n, shape), axes)
