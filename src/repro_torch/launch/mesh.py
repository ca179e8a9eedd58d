"""Device meshes over ``torch.distributed`` (port of ``repro.launch.mesh``).

A ``Mesh`` names its axes and their sizes, as ``jax.make_mesh`` does, and
holds this rank's coordinates and one process group for each axis and for
the data axes together. Ranks are laid out row-major over the axes, so in a
(data, model) mesh the model axis joins neighbouring ranks.

``make_mesh`` builds one over an initialized process group (``init_rank``
initializes it from ``torchrun``'s environment variables); the reference's
production meshes, 16 x 16 (data, model) and 2 x 16 x 16 (pod, data,
model), exist here only as logical meshes for plans
(``make_production_mesh``: no process group, this rank at the origin).
``mesh_info`` and ``n_chips`` return what the reference's do, under the same
keys.

Peaks for rooflines are the H100 SXM data sheet's (bf16 dense tensor-core
FLOP/s, HBM3 bytes/s), in place of the reference's TPU v5e figures.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import os
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

from repro_torch.collectives import Axis

PEAK_FLOPS_BF16 = 989e12      # FLOP/s
HBM_BW = 3.35e12              # B/s

AxisNames = Union[str, Tuple[str, ...]]


@dataclasses.dataclass
class Mesh:
    axis_names: Tuple[str, ...]
    shape: Dict[str, int]              # axis -> size, in axis order
    coords: Dict[str, int]             # this rank's index along each axis
    groups: Dict[Tuple[str, ...], object] = dataclasses.field(default_factory=dict)
    backend: Optional[str] = None      # None: a logical mesh, for plans only
    device: torch.device = torch.device("cpu")

    @staticmethod
    def _names(axes: AxisNames) -> Tuple[str, ...]:
        return (axes,) if isinstance(axes, str) else tuple(axes)

    def size(self, axes: AxisNames) -> int:
        return math.prod(self.shape[a] for a in self._names(axes))

    def index(self, axes: AxisNames) -> int:
        """This rank's row-major index over ``axes`` together."""
        i = 0
        for a in self._names(axes):
            i = i * self.shape[a] + self.coords[a]
        return i

    def axis(self, axes: AxisNames) -> Axis:
        names = self._names(axes)
        size = self.size(names)
        if size > 1 and names not in self.groups:
            raise KeyError(f"no process group over {names} (a logical mesh has none)")
        return Axis(self.groups.get(names), size, self.index(names))

    @property
    def rank(self) -> int:
        return self.index(self.axis_names)


def n_chips(mesh: Mesh) -> int:
    return math.prod(mesh.shape.values())


def mesh_info(mesh: Mesh) -> dict:
    """The dict threaded into the model builders (the reference's keys)."""
    dp = tuple(a for a in mesh.axis_names if a in ("pod", "data"))
    return {"mesh": mesh, "dp": dp, "tp": "model"}


def _coords(rank: int, shape: Sequence[int]) -> Tuple[int, ...]:
    out = []
    for s in reversed(shape):
        out.append(rank % s)
        rank //= s
    return tuple(reversed(out))


def logical_mesh(shape: Sequence[int], axes: Sequence[str]) -> Mesh:
    """A mesh of these axes with no process group, this rank at the origin."""
    return Mesh(tuple(axes), dict(zip(axes, shape)), {a: 0 for a in axes})


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's pod meshes, logical (for plans: ``launch/dryrun.py``)."""
    if multi_pod:
        return logical_mesh((2, 16, 16), ("pod", "data", "model"))
    return logical_mesh((16, 16), ("data", "model"))


def make_mesh(shape: Sequence[int], axes: Sequence[str], backend: str,
              device="cuda") -> Mesh:
    """The mesh over the initialized default process group, whose world
    size must be the product of ``shape``. Every rank builds every group,
    in one order (``torch.distributed.new_group`` is collective): one per
    axis, one over the data axes together where there are two, and one
    over every axis (the MoE aux loss's mean)."""
    import torch.distributed as dist
    world = math.prod(shape)
    if dist.get_world_size() != world:
        raise ValueError(f"mesh {tuple(shape)} needs {world} ranks, the world has "
                         f"{dist.get_world_size()}")
    axes = tuple(axes)
    coords = _coords(dist.get_rank(), shape)
    mesh = Mesh(axes, dict(zip(axes, shape)), dict(zip(axes, coords)),
                backend=backend, device=torch.device(device))
    dp = tuple(a for a in axes if a in ("pod", "data"))
    sets = [(a,) for a in axes] + ([dp] if len(dp) > 1 else []) + [axes]
    for names in sets:
        dims = [axes.index(a) for a in names]
        others = [range(s) if i not in dims else [None] for i, s in enumerate(shape)]
        for fixed in itertools.product(*others):
            members = []
            for sub in itertools.product(*(range(shape[i]) for i in dims)):
                c = list(fixed)
                for i, v in zip(dims, sub):
                    c[i] = v
                members.append(sum(ci * math.prod(shape[j + 1:]) for j, ci in enumerate(c)))
            group = dist.new_group(members) if len(members) > 1 else None
            if all(fixed[i] is None or fixed[i] == coords[i] for i in range(len(shape))):
                mesh.groups[names] = group
    return mesh


def init_rank(backend: str) -> None:
    """Initialize the default process group from ``torchrun``'s environment
    (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT)."""
    import torch.distributed as dist
    missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
               if k not in os.environ]
    if missing:
        raise RuntimeError(f"not started as a rank: {missing} unset (run under torchrun, "
                           "or give the launcher --spawn)")
    if not dist.is_initialized():
        dist.init_process_group(backend, rank=int(os.environ["RANK"]),
                                world_size=int(os.environ["WORLD_SIZE"]))
