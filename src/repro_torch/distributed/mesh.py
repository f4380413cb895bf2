"""Mesh construction (counterpart of ``repro/distributed/mesh.py``).

The port runs on one device, so a mesh's ranks are virtual: a ``Mesh``
names its axes and their sizes, and ``collectives.shard_map`` holds
rank (i, j, ...)'s block of an operand at ``[i, j, ...]`` of the leading
dims. There is no device count to check. The mesh keeps the one torch
device its operands live on: cuda unless the caller names another.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.config import MeshConfig
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Named axes of ``shape`` over virtual ranks on ``device``.
    ``devices`` is the ranks' array (rank ids in mesh order), so
    ``mesh.devices.shape`` reads as the reference's does."""
    shape: tuple[int, ...]
    axis_names: tuple[str, ...]
    device: torch.device

    def __post_init__(self):
        if len(self.shape) != len(self.axis_names) or \
                len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"a mesh of shape {self.shape} takes as many "
                             f"distinct axis names, got {self.axis_names}")
        if any(s < 1 for s in self.shape):
            raise ValueError(f"mesh shape {self.shape}: sizes must be >= 1")

    @property
    def devices(self) -> np.ndarray:
        return np.arange(self.size).reshape(self.shape)

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    def axis_size(self, name: str) -> int:
        return self.shape[self.axis_names.index(name)]


def _device(device) -> torch.device:
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def make_mesh(cfg: MeshConfig, device=None) -> Mesh:
    return Mesh(tuple(cfg.shape), tuple(cfg.axes), _device(device))


def local_mesh(shape=(1, 1), axes=("data", "model"), device=None) -> Mesh:
    """A mesh of ``shape`` over ``axes`` on ``device`` (cuda unless
    given): the tests' and the launcher's."""
    return make_mesh(MeshConfig(tuple(shape), tuple(axes)), device)


def dp_spec(mesh_cfg: MeshConfig):
    """The mesh axes carrying data parallelism, as a spec entry."""
    axes = mesh_cfg.dp_axes
    if len(axes) == 1:
        return axes[0]
    return tuple(axes)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh. On one card it places nothing: it says how the
    reference would lay the tensor out, and ``shard_map`` blocks by it."""
    mesh: Mesh
    spec: tuple


def named(mesh: Mesh, spec) -> NamedSharding:
    return NamedSharding(mesh, spec)
