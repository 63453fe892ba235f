"""Rank layouts: the port's counterpart of the reference's device meshes.

The reference builds `jax.sharding.Mesh`es over the devices one process
sees. The port runs one process per card (`torch.distributed`, one rank
per GPU, `distributed.collectives.init_rank`), so a layout is a shape of
ranks: `data` x `model` (and a leading `pod` axis for two pods), with
this process's rank and device. Building one touches no device state
beyond reading the process group, so importing this module is free.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from ..core.graph_device import resolve_device


@dataclasses.dataclass(frozen=True)
class RankLayout:
    """`shape` ranks along `axis_names`, row-major over the global ranks.
    `rank` and `device` are this process's, or None for a layout
    described without its ranks (`make_production_mesh`)."""

    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    rank: Optional[int] = None
    device: Optional[torch.device] = None

    @property
    def size(self) -> int:
        return int(math.prod(self.shape))

    def as_dict(self) -> dict:
        """{axis: size}, the reference's `zip(mesh.axis_names,
        mesh.devices.shape)`."""
        return dict(zip(self.axis_names, self.shape))


def _world():
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def make_production_mesh(*, multi_pod: bool = False,
                         require_ranks: bool = False) -> RankLayout:
    """16 x 16 = 256 ranks per pod; 2 pods = 512 ranks with a leading
    "pod" axis. Described without the ranks (`graph_job` sizes its cell
    from it); with `require_ranks=True` the process group must hold them
    all, else RuntimeError, as the reference's function raises without 256
    or 512 devices."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = int(math.prod(shape))
    if not require_ranks:
        return RankLayout(shape, axes)
    world, rank = _world()
    if world < need:
        raise RuntimeError(
            f"layout {shape} needs {need} ranks, found {world}; start "
            f"{need} processes (one per card) and call "
            "torch.distributed.init_process_group first")
    if world != need:
        raise RuntimeError(f"layout {shape} needs exactly {need} ranks, "
                           f"the process group has {world}")
    return RankLayout(shape, axes, rank, None)


def make_host_mesh(model_parallel: int = 1, device="cuda") -> RankLayout:
    """The ranks this job has (a world of one without a process group):
    data x model with model = gcd(model_parallel, ranks), the reference's
    rule. The rank's device is `device` ("cuda" is this rank's card,
    `cuda:<local rank>` when several ranks share a host with one card
    each; pass "cpu" for the CPU)."""
    world, rank = _world()
    mp = math.gcd(int(model_parallel), world)
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        resolve_device(dev)
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    return RankLayout((world // mp, mp), ("data", "model"), rank,
                      resolve_device(dev))
