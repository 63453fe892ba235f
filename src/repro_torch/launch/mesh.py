"""Rank layouts: the port's counterpart of the reference's device meshes.

The reference builds `jax.sharding.Mesh`es over the devices one process
sees. The port runs one process per card (`torch.distributed`, one rank
per GPU, `distributed.collectives.init_rank`), so a layout is a shape of
ranks: `data` x `model` (and a leading `pod` axis for two pods), with
this process's rank and device. Building one touches no device state
beyond reading the process group, so importing this module is free.

The sharded train step (`train/step.py`, `distributed/sharding.py`)
needs a rank's coordinates (`axis_index`), a process group per row or
column of the layout (`axis_group`, one `dist.new_group` for each row,
built once per layout and axis set, by every rank in the same order, as
`new_group` requires) and a `Comm` over each (`comm`). The dry-run
(`launch/dryrun.py`) builds a production layout over a fake process
group of 256 or 512 ranks with `make_production_mesh(require_ranks=True,
device="cpu")`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple, Union

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
    #: axis set -> (process group, Comm), built on first use
    _groups: dict = dataclasses.field(default_factory=dict, compare=False,
                                      repr=False)

    @property
    def size(self) -> int:
        return int(math.prod(self.shape))

    def _axes(self, names: Union[str, Sequence[str], None]) -> Tuple[str, ...]:
        if names is None:
            return ()
        names = (names,) if isinstance(names, str) else tuple(names)
        for a in names:
            if a not in self.axis_names:
                raise ValueError(f"no axis {a!r} in layout {self.axis_names}")
        pos = [self.axis_names.index(a) for a in names]
        if pos != sorted(set(pos)):
            # a group's ranks are sorted (`dist.new_group`): fused indices
            # follow them only in the layout's axis order
            raise ValueError(f"axes {names} must appear once each, in the "
                             f"layout's order {self.axis_names}")
        return names

    def coords(self, rank: Optional[int] = None) -> Tuple[int, ...]:
        """A rank's index along every axis (row-major over the ranks)."""
        r = self.rank if rank is None else rank
        if r is None:
            raise ValueError("a layout described without its ranks has no "
                             "coordinates")
        out = []
        for n in reversed(self.shape):
            out.append(r % n)
            r //= n
        return tuple(reversed(out))

    def axis_size(self, names) -> int:
        """The product of the sizes of `names` (an axis or a tuple)."""
        sizes = self.as_dict()
        return int(math.prod(sizes[a] for a in self._axes(names)))

    def axis_index(self, names, rank: Optional[int] = None) -> int:
        """This rank's (or `rank`'s) index along `names`: one axis, or
        several fused row-major in the order given (the reference's
        convention for a dim sharded over several mesh axes)."""
        c = dict(zip(self.axis_names, self.coords(rank)))
        sizes = self.as_dict()
        idx = 0
        for a in self._axes(names):
            idx = idx * sizes[a] + c[a]
        return idx

    def group_ranks(self, names, rank: Optional[int] = None) -> list:
        """The global ranks that share this rank's (or `rank`'s)
        coordinates off `names`, in `axis_index(names)` order."""
        names = self._axes(names)
        c = dict(zip(self.axis_names, self.coords(rank)))
        sizes = self.as_dict()
        out = []
        for i in range(self.axis_size(names)):
            cc, j = dict(c), i
            for a in reversed(names):
                cc[a] = j % sizes[a]
                j //= sizes[a]
            r = 0
            for a in self.axis_names:
                r = r * sizes[a] + cc[a]
            out.append(r)
        return out

    def axis_group(self, names):
        """The process group of this rank's row along `names` (an axis or
        a tuple of axes); group rank i is `axis_index(names)` i. Every
        rank must ask for the same axis sets in the same order: the first
        call builds one group per row (`dist.new_group` on every rank, the
        rows in rank order). The whole world is the default group (None);
        an axis set of size 1 has no group (None) and an identity Comm."""
        return self._entry(names)[0]

    def comms(self) -> list:
        """Every Comm this layout has built (their tallies sum to the
        rank's collectives)."""
        return [c for _, c in self._groups.values()]

    def comm(self, names):
        """A `distributed.collectives.Comm` over `axis_group(names)` on
        this rank's device (built once, with the group)."""
        return self._entry(names)[1]

    def _entry(self, names):
        from ..distributed.collectives import Comm
        names = self._axes(names)
        if names not in self._groups:
            if self.rank is None:
                raise ValueError("a layout described without its ranks has "
                                 "no process groups")
            world, _ = _world()
            if world != self.size:
                raise RuntimeError(f"layout {self.shape} needs a process "
                                   f"group of {self.size} ranks, found "
                                   f"{world}")
            mine = self.group_ranks(names)
            dev = self.device if self.device is not None else "cpu"
            if len(mine) == 1:
                self._groups[names] = (None, Comm(dev, alone=True))
                return self._groups[names]
            if len(mine) == self.size:
                # the default group, by None: a layout that held the WORLD
                # object would keep the destroyed group's gloo threads
                # alive into interpreter teardown
                group = None
            else:
                group, seen = None, set()
                for r in range(self.size):
                    row = tuple(self.group_ranks(names, r))
                    if row in seen:
                        continue
                    seen.add(row)
                    g = dist.new_group(list(row))
                    if self.rank in row:
                        group = g
            self._groups[names] = (group, Comm(dev, group))
        return self._groups[names]

    def as_dict(self) -> dict:
        """{axis: size}, the reference's `zip(mesh.axis_names,
        mesh.devices.shape)`."""
        return dict(zip(self.axis_names, self.shape))


def _world():
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def make_production_mesh(*, multi_pod: bool = False,
                         require_ranks: bool = False,
                         device=None) -> RankLayout:
    """16 x 16 = 256 ranks per pod; 2 pods = 512 ranks with a leading
    "pod" axis. Described without the ranks (`graph_job` sizes its cell
    from it); with `require_ranks=True` the process group must hold them
    all, else RuntimeError, as the reference's function raises without 256
    or 512 devices, and the layout carries this process's rank and
    `device` (the dry-run's fake group passes "cpu")."""
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
    return RankLayout(shape, axes, rank,
                      None if device is None else torch.device(device))


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
