"""Mesh definitions (reference `repro.launch.mesh`, whose target is TPU
v5e pods).

The reference's production meshes place the model on 256 or 512 TPU
chips: single pod (data=16, model=16), multi-pod (pod=2, data=16,
model=16), the "pod" axis carrying the federated client population. The
port runs in one process on one card and places nothing: a `Mesh` here
is a small data object with the reference's shape and axis names, which
`utils.sharding.MeshAxes.from_mesh` and the spec functions of
`launch.specs` read. No function here opens a process group or touches
a device.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class Mesh:
    """Axis sizes and names (the counterpart of `jax.sharding.Mesh`'s
    `devices.shape` and `axis_names`)."""

    axis_sizes: tuple
    axis_names: tuple

    @property
    def shape(self) -> dict:
        """{axis name: size}, as `jax.sharding.Mesh.shape`."""
        return dict(zip(self.axis_names, self.axis_sizes))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes)


def make_host_mesh(*, data: int | None = None, model: int = 1) -> Mesh:
    """A (data, model) mesh over the CUDA cards of this host (the CPU
    counts as one device where there is no card)."""
    n = torch.cuda.device_count() or 1
    data = data or (n // model)
    return Mesh((data, model), ("data", "model"))


def mesh_num_devices(mesh) -> int:
    return int(math.prod(mesh.axis_sizes))
