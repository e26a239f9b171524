"""Forest-inference sharding over a device mesh (torch).

Mirrors the forest half of ``repro/dist/sharding.py`` (``ForestShardingPlan``,
``make_forest_plan``).  The paper's two parallelism modes are mesh axes:

  ``data``   sample blocks: each page batch is split into ``n_data`` row
             shards, shard d computed at the positions (d, *);
  ``model``  tree blocks: the relation-centric plan gives each position
             (*, m) one contiguous tree shard, and the model-axis partials
             are folded in model order.

The reference's mesh is ``jax.sharding.Mesh`` driven through ``shard_map``
by one controller.  The port keeps the single controller: ``Mesh`` is a
plain grid of ``torch.device`` positions that one process addresses, and
the placements below take the place of PartitionSpecs (the row shards of
a page batch are the scan's, ``db/shards.py``).  A position is a place in
the grid, not a card: one device may stand at several positions (the CPU
tests' eight ``"cpu"`` positions, eight ``cuda:0`` positions on a one-card
machine).  Positions that share a device launch one after another on its
current stream, and whatever is replicated over positions (a data shard
over ``model``, a forest or tree shard over ``data``) is held ONCE per
physical device.  A placement is built by the plan that runs it and lives
with that plan (the udf plan's replicas, the partition stage's tree
shards in ``MaterializedModel.aux``), so it goes when its plan is evicted
or invalidated.

Of the LM half of the reference module, ``ShardingPlan`` and the mesh-less
``make_plan(cfg, None)`` that every serving call uses are ported: the plan
holds no mesh and no specs, and the layers place no constraint under it.
``make_plan`` with a mesh, the plan's specs, ``param_specs``,
``batch_specs``, ``cache_specs`` and ``tree_named`` wait for ROADMAP queue 1
item 13e.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core.forest import tree_slice

__all__ = ["Mesh", "ForestShardingPlan", "make_forest_plan", "physical",
           "replica", "ShardingPlan", "make_plan"]

#: the mesh axes the forest plans read
AXES = ("data", "model")


def physical(device: torch.device | str) -> torch.device:
    """The device a position names, with a CUDA index filled in (``cuda``
    and ``cuda:0`` are one card when 0 is current), so that replicas are
    keyed by card and not by spelling."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """A named grid of device positions: ``devices`` holds one
    ``torch.device`` a position (repeats allowed), ``axis_names`` one name
    an axis, taken from ``("data", "model")``.  Every position has one
    device type."""

    def __init__(self, devices, axis_names):
        names = tuple(axis_names)
        grid = np.asarray(devices, dtype=object)
        flat = [torch.device(d) for d in grid.flat]
        if not flat:
            raise ValueError("a mesh needs at least one position")
        if grid.ndim != len(names):
            raise ValueError(f"{grid.ndim}-d devices for axes {names}")
        if len(set(names)) != len(names) or not set(names) <= set(AXES):
            raise ValueError(f"mesh axes must be distinct names from "
                             f"{AXES}, got {names}")
        types = sorted({d.type for d in flat})
        if len(types) != 1:
            raise ValueError(f"a mesh's positions must share one device "
                             f"type, got {types}")
        arr = np.empty(len(flat), dtype=object)
        arr[:] = flat
        self.devices = arr.reshape(grid.shape)
        self.axis_names = names

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def device_type(self) -> str:
        return self.devices.flat[0].type

    def physical_devices(self) -> list[torch.device]:
        """The distinct devices behind the positions, in position order."""
        out: list[torch.device] = []
        for d in self.devices.flat:
            p = physical(d)
            if p not in out:
                out.append(p)
        return out

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, devices="
                f"{[str(d) for d in self.devices.flat]})")


# -- placements ---------------------------------------------------------------

def replica(forest, device: torch.device):
    """``forest`` on ``device``: itself where it lies, else a copy."""
    if physical(forest.device) == physical(device):
        return forest
    return forest.to(device)


@dataclasses.dataclass(frozen=True)
class ForestShardingPlan:
    """Frozen axis mapping for multi-device forest inference.

    ``data_axis`` / ``model_axis`` name the mesh axes that exist (None:
    that parallelism is off), ``n_data`` / ``n_model`` their sizes (1 when
    absent).  ``grid`` is the mesh's devices as [n_data, n_model]."""

    mesh: Any                        # Mesh | None (None = one device)
    data_axis: str | None
    model_axis: str | None
    n_data: int
    n_model: int
    grid: Any = dataclasses.field(default=None, repr=False, compare=False)

    @property
    def positions(self) -> int:
        """The mesh's positions (1 off-mesh)."""
        return 1 if self.mesh is None else self.mesh.size

    def position(self, d: int, m: int) -> torch.device:
        """The device at position (d, m)."""
        return self.grid[d, m]

    @property
    def data_devices(self) -> tuple[torch.device, ...]:
        """The home of each data shard: position (d, 0)."""
        return tuple(self.grid[d, 0] for d in range(self.n_data))

    def replicas(self, forest) -> dict[torch.device, Any]:
        """The forest replicated over ``data``: one copy a physical device
        of the data homes (the forest itself where it lies)."""
        return {physical(dev): replica(forest, dev)
                for dev in self.data_devices}

    def forest_shardings(self, forest):
        """Where each tree shard of ``forest`` lives: per model shard m,
        (first tree, count, the distinct devices of positions (*, m)).
        Shards are contiguous and equal, so the axis must divide the trees
        (the partition stage pads).  None without a model axis."""
        if self.model_axis is None:
            return None
        T = forest.num_trees
        if T % self.n_model:
            raise ValueError(f"{T} trees do not divide the model axis "
                             f"({self.n_model})")
        per = T // self.n_model
        out = []
        for m in range(self.n_model):
            devs: list[torch.device] = []
            for d in range(self.n_data):
                p = physical(self.position(d, m))
                if p not in devs:
                    devs.append(p)
            out.append((m * per, per, tuple(devs)))
        return out

    def shard_forest(self, forest) -> list[dict[torch.device, Any]]:
        """Lay a forest's tree blocks out over the ``model`` axis: tree
        shard m replicated over ``data`` once a physical device,
        ``[m][device] -> Forest`` (a shard on the forest's own device is a
        view of its arrays).  The relation-centric plans' partition stage
        places a model through this and keeps the shards with the
        materialized model."""
        shards = []
        for lo, n, devs in self.forest_shardings(forest):
            part = tree_slice(forest, lo, n)
            shards.append({dev: replica(part, dev) for dev in devs})
        return shards


def _grid(mesh: Mesh) -> np.ndarray:
    names, arr = mesh.axis_names, mesh.devices
    if "data" in names and "model" in names:
        return arr if names.index("data") == 0 else arr.T
    if "data" in names:
        return arr.reshape(-1, 1)
    return arr.reshape(1, -1)


def make_forest_plan(mesh: Mesh | None) -> ForestShardingPlan:
    """The forest-inference axis mapping for ``mesh`` (one device when
    None)."""
    if mesh is None:
        return ForestShardingPlan(mesh=None, data_axis=None, model_axis=None,
                                  n_data=1, n_model=1)
    names = mesh.axis_names
    data = "data" if "data" in names else None
    model = "model" if "model" in names else None
    return ForestShardingPlan(
        mesh=mesh, data_axis=data, model_axis=model,
        n_data=mesh.shape["data"] if data else 1,
        n_model=mesh.shape["model"] if model else 1, grid=_grid(mesh))


# -- the LM plan --------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShardingPlan:
    """Sharding policy for one (LM config, mesh).  Mesh-less only: the
    reference's specs and attention mode arrive with the mesh that reads
    them (item 13e)."""

    mesh: Any = None


def make_plan(cfg, mesh) -> ShardingPlan:
    """The plan for ``cfg`` on ``mesh``: with no mesh (or one without axes)
    the reference's mesh-less plan."""
    if mesh is None or not getattr(mesh, "axis_names", ()):
        return ShardingPlan()
    raise NotImplementedError(
        "the LM on a mesh (make_plan with a mesh, param_specs, batch_specs, "
        "cache_specs) is ROADMAP queue 1 item 13e, not ported yet")
