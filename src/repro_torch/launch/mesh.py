"""Mesh builders.

Functions (not module-level constants), so importing this module touches no
process-group state: ``dryrun.py`` sets up its fake process group first.

  make_production_mesh(multi_pod)  16x16 ("data", "model") or 2x16x16
      ("pod", "data", "model") over the process group in place, which the
      dry-run makes a fake one of 256 or 512 ranks (``fake_process_group``)
  make_smoke_mesh(device)          (1, n) over the real local devices: NCCL
      at world size 1 on the card, gloo on the CPU
"""
from __future__ import annotations

import contextlib
import socket

import torch
import torch.distributed as dist


def production_shape(multi_pod: bool = False):
    """(mesh shape, axis names): a 256-card slice or two of them."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def fake_process_group(world_size: int, rank: int = 0) -> None:
    """A process group of ``world_size`` ranks that sends nothing: every
    collective returns at once with its output uninitialised (the dry-run
    traces on fake tensors, whose values are never read)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world_size)


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cpu"):
    """16x16 or 2x16x16 over the process group in place (its world size must
    be the mesh's: 256 or 512)."""
    from torch.distributed.device_mesh import init_device_mesh

    shape, names = production_shape(multi_pod)
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def free_port() -> int:
    with contextlib.closing(socket.socket(socket.AF_INET, socket.SOCK_STREAM)) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def make_smoke_mesh(device: str = "cuda"):
    """A (1, n) ("data", "model") mesh over this process alone: NCCL at
    world size 1 on the card, gloo on the CPU.  Starts the process group
    when none is in place."""
    from torch.distributed.device_mesh import init_device_mesh

    device_type = torch.device(device).type
    if not dist.is_initialized():
        dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                                init_method=f"tcp://localhost:{free_port()}",
                                world_size=1, rank=0)
    n = dist.get_world_size()
    return init_device_mesh(device_type, (1, n), mesh_dim_names=("data", "model"))
