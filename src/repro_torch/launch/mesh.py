"""Mesh builders over an initialised ``torch.distributed`` process group.
The counterpart of ``repro.launch.mesh``: the same shapes and axis names
(``place``, ``data``, ``model``, ``pod``), as
``torch.distributed.device_mesh.init_device_mesh``. Functions, not module
constants, so that importing touches no process group.

A mesh holds every rank of the world, one per process (on this repo's one
card machine, several processes may share ``cuda:0``). The caller
initialises the group (``torchrun`` or ``launch.ranks.run_ranks``) and
chooses its backend; a mesh whose size is not the world size raises.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def _mesh(shape: Sequence[int], axes: Sequence[str],
          device_type: str) -> DeviceMesh:
    if not dist.is_initialized():
        raise RuntimeError(
            "no process group: initialise torch.distributed (torchrun, or "
            "repro_torch.launch.ranks.run_ranks) before building a mesh")
    n = 1
    for s in shape:
        n *= s
    if n != dist.get_world_size():
        raise ValueError(f"a mesh of shape {tuple(shape)} needs {n} ranks; "
                         f"the world has {dist.get_world_size()}")
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """Single pod: 16x16 = 256 ranks (data, model). Multi-pod: 2 pods x
    256 with a leading ``pod`` axis (DP across pods)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device_type)


def make_glb_mesh(*, multi_pod: bool = False, n: Optional[int] = None,
                  device_type: str = "cuda") -> DeviceMesh:
    """1-D ``place`` mesh for the paper's GLB workloads, one place per
    process: 256 places single-pod, 512 multi-pod, or ``n``."""
    if n is None:
        n = 512 if multi_pod else 256
    return _mesh((n,), ("place",), device_type)


def make_host_mesh(n: Optional[int] = None, axis: str = "place",
                   device_type: str = "cuda") -> DeviceMesh:
    """1-D mesh over the world (``n`` ranks, the world size when None) —
    tests and examples."""
    if n is None:
        n = dist.get_world_size() if dist.is_initialized() else 1
    return _mesh((n,), (axis,), device_type)
