"""Mesh construction (``repro.launch.mesh`` in the port).

Functions, not module constants: importing this module starts no process
group and touches no device.

- ``make_production_mesh(multi_pod)``: the 16 x 16 = 256-rank
  ("data", "model") mesh, or the 2 x 16 x 16 = 512-rank ("pod", "data",
  "model") mesh, over a fake process group in this one process: its
  collectives move nothing and no device is used. The dry run lowers
  onto it.
- ``make_host_mesh(model_axis, device)``: the mesh over the real ranks.
  One process drives one device, so in a process of its own this is a
  (1, 1) mesh over ``cuda:0`` on NCCL (or the CPU on gloo when the
  caller asks for it); in a group the caller started (``torch.distributed``
  launched N processes), it spans their N ranks.

Groups start from an in-process store (``HashStore``, or the fake
group's store): no TCP port, no network. ``ensure_process_group``
reuses a group of the same backend and size and tears down any other,
so two meshes in one process, one after the other, are safe.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist

_BACKEND = {"cuda": "nccl", "cpu": "gloo"}


def ensure_process_group(backend: str, world_size: int, rank: int = 0,
                         device: Optional[torch.device] = None) -> None:
    """A default process group of ``backend`` and ``world_size`` with this
    process as ``rank``: the one that is up when it matches, else a new
    one (any other is destroyed first)."""
    if dist.is_initialized():
        if (dist.get_backend() == backend and dist.get_world_size() == world_size
                and dist.get_rank() == rank):
            return
        destroy_process_group()
    if backend == "fake":
        from torch.testing._internal.distributed.fake_pg import FakeStore

        dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world_size)
        return
    kw = {"device_id": device} if backend == "nccl" else {}
    dist.init_process_group(backend, store=dist.HashStore(), rank=rank,
                            world_size=world_size, **kw)


def destroy_process_group() -> None:
    """Tear down the default group (and its sub-groups) if one is up."""
    if dist.is_initialized():
        dist.destroy_process_group()


def make_production_mesh(*, multi_pod: bool = False):
    """(16, 16) ("data", "model") or (2, 16, 16) ("pod", "data", "model")
    over a fake group of 256 or 512 ranks; this process is rank 0."""
    from torch.distributed.device_mesh import init_device_mesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    ensure_process_group("fake", math.prod(shape))
    return init_device_mesh("cpu", shape, mesh_dim_names=names)


def make_host_mesh(model_axis: int = 1, device: str = "cuda"):
    """("data", "model") mesh over the real ranks: world // model_axis by
    model_axis. Without a group of the device's backend already up, one
    of a single rank starts here (NCCL on ``cuda``, gloo on ``cpu``)."""
    from torch.distributed.device_mesh import init_device_mesh

    dev = torch.device(device)
    if dev.type not in _BACKEND:
        raise ValueError(f"no host mesh for device {device!r}")
    backend = _BACKEND[dev.type]
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("make_host_mesh(device='cuda') needs a CUDA device; "
                               "pass device='cpu' for a gloo mesh on the CPU")
        dev = torch.device("cuda", torch.cuda.current_device() if dev.index is None else dev.index)
        torch.cuda.set_device(dev)
    if dist.is_initialized() and dist.get_backend() == backend:
        world = dist.get_world_size()
    else:
        world = 1
        ensure_process_group(backend, 1, device=dev)
    if world % model_axis:
        raise ValueError(f"{world} ranks do not split into a model axis of {model_axis}")
    return init_device_mesh(dev.type, (world // model_axis, model_axis),
                            mesh_dim_names=("data", "model"))
