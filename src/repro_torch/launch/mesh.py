"""Port of repro/launch/mesh.py: the production meshes.

Functions, not module-level constants, so importing this module touches no
device. A mesh is ``ParallelConfig.build_mesh`` over the devices of
``device`` (the card's distinct devices, ``REPRO_TORCH_VIRTUAL_DEVICES``
virtual ones, or for ``device="meta"`` an abstract mesh that needs no
device: the dry-run cells' ``launch.cells``): with fewer devices than the
mesh needs it raises ``ValueError``, as ``jax.make_mesh`` does.
"""
from __future__ import annotations

import os

import torch

from ..distributed.sharding import VIRTUAL_DEVICES_ENV, Mesh, ParallelConfig


def make_production_mesh(*, multi_pod: bool = False,
                         device="cuda") -> Mesh:
    """16 x 16 = 256 devices; ``multi_pod`` stacks 2 pods -> 512.

    Axis roles: "pod" = cross-pod data parallelism, "data" = FSDP + batch
    DP, "model" = TP / EP."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return ParallelConfig(shape, axes).build_mesh(device=device)


def make_host_mesh(device="cpu") -> Mesh:
    """A single-device mesh (axis names preserved), on ``device``."""
    return Mesh([torch.device(device)], (1, 1), ("data", "model"))


def visible_devices(device="cuda") -> int:
    """How many devices a mesh on ``device`` could take:
    ``REPRO_TORCH_VIRTUAL_DEVICES`` where set, else the distinct cards for
    a CUDA device and 1 for the CPU."""
    virtual = os.environ.get(VIRTUAL_DEVICES_ENV)
    if virtual:
        return int(virtual)
    if torch.device(device).type == "cuda":
        return torch.cuda.device_count()
    return 1


__all__ = ["make_host_mesh", "make_production_mesh", "visible_devices"]
