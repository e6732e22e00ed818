"""Device meshes over the ranks of a ``torch.distributed`` world.

Functions, not module-level constants: importing this module starts no
process group and touches no card.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from ..device import DeviceLike, resolve_device


def _mesh(device_type: str, shape: Tuple[int, ...], names: Tuple[str, ...]):
    world = dist.get_world_size()
    if world != math.prod(shape):
        raise ValueError(f"a {shape} mesh needs {math.prod(shape)} ranks; "
                         f"the world has {world}")
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, device: DeviceLike = None):
    """Single pod: (data=16, model=16) = 256 ranks. Multi-pod:
    (pod=2, data=16, model=16) = 512 ranks.

    The world (256 or 512 ranks) must exist already. Without a cluster of
    that size, PyTorch's fake process group stands in for one: in a
    process of its own, ``dist.init_process_group("fake", store=FakeStore(),
    rank=0, world_size=256)`` (``torch.testing._internal.distributed.
    fake_pg``), then ``make_production_mesh(device="cpu")``; the rules and
    layouts can be read off it, no collective carries data."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(resolve_device(device).type, shape, names)


def make_host_mesh(model: int = 1, device: DeviceLike = None):
    """A ("data", "model") mesh over every rank of the world, ``model``
    ranks on the model axis: NCCL on the cards unless the caller asks for
    the CPU (gloo). Where no process group exists it starts a world of one
    over an in-process store (a user starts a larger world first, e.g.
    under ``torchrun --nproc-per-node N``)."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
    world = dist.get_world_size()
    if world % model:
        raise ValueError(f"model={model} does not divide the world's {world} ranks")
    return _mesh(dev.type, (world // model, model), ("data", "model"))
