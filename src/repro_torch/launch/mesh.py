"""Meshes on ``torch.distributed``.

Port of ``repro.launch.mesh``.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the
default process group, with dim names ``("data", "model")`` or ``("pod",
"data", "model")``; its ``ShardingPlan`` (``sharding/plan.py``) maps
parameters and batches onto it.  :func:`init_distributed` starts the
group: NCCL on CUDA, where each rank takes ``cuda:LOCAL_RANK``, gloo on
the CPU; neither gives way to the other.  It reads the environment that
``torchrun`` sets or takes an ``init_method`` (a ``file://`` store, as the
tests and ``chip_smoke.py`` pass).  The reference's ``mesh_kwargs`` only
shims JAX versions and has no counterpart.

The mesh functions are functions, not module constants, so importing
this module starts nothing; the production shapes are a pure function
(:func:`production_mesh_shape`), checked without 512 ranks.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from ..device import resolve_device

__all__ = ["init_distributed", "make_production_mesh", "make_test_mesh",
           "production_mesh_shape"]


def init_distributed(device=None, init_method: Optional[str] = None,
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None) -> torch.device:
    """Start the default process group for ``device`` (CUDA unless the
    caller asks for the CPU): NCCL on ``cuda:LOCAL_RANK``, gloo on the
    CPU.  ``rank``/``world_size`` default to ``RANK``/``WORLD_SIZE`` and
    ``init_method`` to ``env://`` (``MASTER_ADDR``/``MASTER_PORT``, as
    ``torchrun`` sets them).  A group already started for the same
    backend is kept.  Returns the rank's device."""
    import torch.distributed as dist
    dev = resolve_device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"no process group backend for device {dev}")
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", dev.index or 0))
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        have = dist.get_backend()
        if have != backend:
            raise RuntimeError(f"a {have} process group is running; "
                               f"{dev} needs {backend}")
        return dev
    rank = int(os.environ.get("RANK", 0)) if rank is None else rank
    world_size = (int(os.environ.get("WORLD_SIZE", 1)) if world_size is None
                  else world_size)
    if init_method is None:
        missing = [k for k in ("MASTER_ADDR", "MASTER_PORT")
                   if k not in os.environ]
        if missing:
            raise ValueError(
                f"init_distributed: no init_method and no {missing} in the "
                f"environment (run under torchrun, or pass a file:// "
                f"init_method)")
        init_method = "env://"
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size)
    return dev


def _mesh(shape: tuple, names: tuple, device, who: str):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    need = 1
    for s in shape:
        need *= s
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have != need:
        raise ValueError(f"{who} needs a process group of {need} ranks "
                         f"(mesh {shape}), got {have}")
    dev = resolve_device(device)
    return init_device_mesh(dev.type, shape, mesh_dim_names=names)


def production_mesh_shape(multi_pod: bool = False):
    """``(shape, axis names)`` of the production mesh: one pod 16x16 =
    256 ranks (data, model); two pods 2x16x16 = 512 (pod, data, model),
    the ``pod`` axis pure data parallelism across the datacenter
    interconnect."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """The production mesh on a process group of 256 (or 512) ranks."""
    shape, names = production_mesh_shape(multi_pod)
    return _mesh(shape, names, device, "make_production_mesh")


def make_test_mesh(data: int = 2, model: int = 4, device=None):
    """A small ``(data, model)`` mesh; needs a process group of exactly
    ``data * model`` ranks."""
    return _mesh((data, model), ("data", "model"), device,
                 f"make_test_mesh({data}, {model})")
