"""Sharding over a device mesh (torch): the forest plans and the LM's.

Mirrors ``repro/dist/sharding.py``.  The reference's mesh is
``jax.sharding.Mesh`` driven by one controller (``shard_map`` for the
forest plans, ``with_sharding_constraint`` and ``shard_map`` for the LM).
The port keeps the single controller: ``Mesh`` is a plain grid of
``torch.device`` positions that one process addresses.  A position is a
place in the grid, not a card: one device may stand at several positions
(the CPU tests' eight ``"cpu"`` positions, eight ``cuda:0`` positions on
a one-card machine).

Forest inference (``ForestShardingPlan``, ``make_forest_plan``) reads two
axes:

  ``data``   sample blocks: each page batch is split into ``n_data`` row
             shards, shard d computed at the positions (d, *);
  ``model``  tree blocks: the relation-centric plan gives each position
             (*, m) one contiguous tree shard, and the model-axis partials
             are folded in model order.

Positions that share a device launch one after another on its current
stream, and whatever is replicated over positions (a data shard over
``model``, a forest or tree shard over ``data``) is held ONCE per physical
device.  A placement is built by the plan that runs it and lives with that
plan (the udf plan's replicas, the partition stage's tree shards in
``MaterializedModel.aux``), so it goes when its plan is evicted or
invalidated.  A mesh with a ``pod`` axis is the LM's: the forest plans
refuse it (the reference's read only ``data`` and ``model`` and would
silently replicate over ``pod``).

The LM (``ShardingPlan``, ``make_plan``, ``param_specs``, ``batch_specs``,
``cache_specs``, ``tree_named``) runs on a mesh of positions on ONE
physical device: parameters, caches and activations are held once there,
the specs are data that ``models/layers.shard`` checks as the reference's
constraint checks them, and what a mesh changes in the results (the MoE's
per-block dispatch and expert exchange, the EP decode's per-shard sum, the
cross-pod gradient compression) runs block by block in the layers and the
trainer.  An LM mesh over distinct cards raises ``NotImplementedError``
(ROADMAP queue 1 item 13g).  ``P`` is the port's PartitionSpec: a tuple
of entries, each None, an axis name or a tuple of names; the spec
functions accept any object with ``.shape`` and ``.axis_names``, as the
reference's do (``docs/torch_lm_mesh.md``).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core.forest import tree_slice
from repro_torch.train.tree import tree_map, tree_map_with_path

__all__ = ["Mesh", "ForestShardingPlan", "make_forest_plan", "physical",
           "replica", "P", "NamedSharding", "ShardingPlan", "make_plan",
           "lm_device", "param_specs", "batch_specs", "cache_specs",
           "tree_named"]

#: the mesh axes: ``pod`` (the LM's cross-pod data axis), ``data``, ``model``
AXES = ("pod", "data", "model")

#: the ROADMAP item an LM mesh over distinct cards waits for
DISTINCT_CARDS_ITEM = "13g"


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
    an axis, taken from ``("pod", "data", "model")``.  Every position has
    one device type."""

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
    None).  A ``pod`` axis raises: the forest plans read only ``data`` and
    ``model``."""
    if mesh is None:
        return ForestShardingPlan(mesh=None, data_axis=None, model_axis=None,
                                  n_data=1, n_model=1)
    names = mesh.axis_names
    if "pod" in names:
        raise ValueError(f"the forest plans read the data and model axes; "
                         f"a mesh with a pod axis {names} is the LM's")
    data = "data" if "data" in names else None
    model = "model" if "model" in names else None
    return ForestShardingPlan(
        mesh=mesh, data_axis=data, model_axis=model,
        n_data=mesh.shape["data"] if data else 1,
        n_model=mesh.shape["model"] if model else 1, grid=_grid(mesh))


# -- the LM plan --------------------------------------------------------------

#: leaves below this many elements are replicated (biases, norms, routers)
_MIN_SHARD_SIZE = 1 << 18

#: top-level keys whose leaves carry a leading stacked-blocks dim, which is
#: never sharded
_STACKED_COLLECTIONS = ("blocks", "lora", "enc_blocks", "dec_blocks")


class P(tuple):
    """PartitionSpec: one entry a dimension, each None (replicated), an
    axis name or a tuple of names (the dimension split over their product,
    the first axis major).  A one-name tuple is that name, as jax's
    ``PartitionSpec`` canonicalizes it.  Trailing dimensions past the spec
    are replicated."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}" if len(self) != 1 else \
            f"P({self[0]!r})"


def _entry_axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def check_spec(spec: P, ndim: int, mesh) -> None:
    """Raise ``ValueError`` where the reference's constraint raises: a spec
    longer than the rank, an axis the mesh lacks, an axis used twice."""
    if len(spec) > ndim:
        raise ValueError(f"spec {spec!r} has {len(spec)} entries for a "
                         f"rank-{ndim} array")
    names = tuple(mesh.axis_names)
    used: list[str] = []
    for entry in spec:
        for a in _entry_axes(entry):
            if a not in names:
                raise ValueError(f"axis {a!r} of {spec!r} is not in the "
                                 f"mesh's axes {names}")
            if a in used:
                raise ValueError(f"spec {spec!r} maps axis {a!r} to more "
                                 f"than one dimension")
            used.append(a)


def lm_device(mesh) -> torch.device:
    """The one physical device an LM mesh's positions stand on.  Positions
    over distinct cards raise ``NotImplementedError``: they need real
    collectives (ROADMAP queue 1 item 13g)."""
    devs = mesh.physical_devices()
    if len(devs) != 1:
        raise NotImplementedError(
            f"the LM over distinct cards ({[str(d) for d in devs]}) is "
            f"ROADMAP queue 1 item {DISTINCT_CARDS_ITEM}, not ported yet; "
            f"place every position on one device")
    return devs[0]


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A placement: ``spec`` over ``mesh``.  ``devices_indices_map`` says
    which index slices each position holds, as jax's
    ``NamedSharding.devices_indices_map`` does, keyed by the position's
    index in the grid; ``place`` puts a tensor on the mesh's one device,
    held once for every position."""

    mesh: Any
    spec: P

    def _parts(self, shape) -> list[tuple]:
        """(axes, parts, part length) of each dimension of ``shape``,
        after the checks a placement makes: ``check_spec``'s, and every
        split even."""
        shape = tuple(int(s) for s in shape)
        check_spec(self.spec, len(shape), self.mesh)
        spec = tuple(self.spec) + (None,) * (len(shape) - len(self.spec))
        parts = []
        for dim, entry in zip(shape, spec):
            axes = _entry_axes(entry)
            n = int(np.prod([self.mesh.shape[a] for a in axes] or [1]))
            if dim % n:
                raise ValueError(
                    f"{self.spec!r} splits a dimension of {dim} into {n} "
                    f"parts (full shape {shape}); the parts must divide it "
                    f"evenly")
            parts.append((axes, n, dim // n))
        return parts

    def shard_shape(self, shape) -> tuple[int, ...]:
        """The shape of one position's shard of ``shape`` (every split is
        even), as jax's ``NamedSharding.shard_shape``."""
        return tuple(n for _, _, n in self._parts(shape))

    def devices_indices_map(self, shape) -> dict[tuple, tuple]:
        parts = self._parts(shape)
        names = tuple(self.mesh.axis_names)
        sizes = [int(self.mesh.shape[a]) for a in names]
        out = {}
        for pos in np.ndindex(*sizes):
            at = dict(zip(names, pos))
            idx = []
            for axes, n, step in parts:
                if not axes:
                    idx.append(slice(None))
                    continue
                k = 0
                for a in axes:                     # the first axis major
                    k = k * int(self.mesh.shape[a]) + at[a]
                idx.append(slice(k * step, (k + 1) * step))
            out[tuple(int(i) for i in pos)] = tuple(idx)
        return out

    def place(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` on the mesh's device (itself where it lies), after the
        checks a placement makes of its shape (no index map is built)."""
        self._parts(t.shape)
        dev = lm_device(self.mesh)
        return t if physical(t.device) == dev else t.to(dev)


@dataclasses.dataclass(frozen=True)
class ShardingPlan:
    """Frozen sharding policy for one (LM config, mesh, phase).  The
    defaults are the mesh-less plan."""

    mesh: Any = None                 # Mesh | None (None = no mesh)
    attn_mode: str = "cp"            # "tp" | "cp"
    data_axes: tuple = ()            # ("data",) or ("pod", "data")
    model_axis: str | None = None    # "model" when the mesh has one
    # activation specs
    hidden: P = P()                  # train/prefill hidden   [B, S, D]
    decode_hidden: P = P()           # decode hidden          [B, 1, D]
    qkv: P = P()                     # projected queries      [B, S, H, dh]
    kv_ctx: P = P()                  # full-context K/V       [B, Sk, KV, dh]
    decode_cache: P = P()            # decode-time K/V cache  [B, Sc, KV, dh]
    ssm_state: P = P()               # SSD recurrent state    [B, H, P, N]

    def block_counts(self) -> tuple[int, int]:
        """(data blocks: the product of the data axes, model blocks)."""
        shape = self.mesh.shape
        n_data = int(np.prod([shape[a] for a in self.data_axes] or [1]))
        return n_data, int(shape[self.model_axis]) if self.model_axis else 1


def _data_entry(data_axes: tuple):
    if not data_axes:
        return None
    return data_axes[0] if len(data_axes) == 1 else data_axes


def make_plan(cfg, mesh, decode_batch: int | None = None) -> ShardingPlan:
    """The plan for ``cfg`` on ``mesh`` (the reference's rules): head
    tensor parallelism (``tp``) when both head counts divide the model
    axis, else context parallelism (``cp``); decode replicates a batch
    smaller than the data axes (``decode_batch``) and shards the cache's
    sequence over every axis; SSD heads over ``model`` when they divide.
    No mesh (or one without axes) gives the mesh-less plan; ``mesh`` may be
    any object with ``.shape`` / ``.axis_names``, and a port ``Mesh`` over
    distinct cards raises (``lm_device``)."""
    if mesh is None or not getattr(mesh, "axis_names", ()):
        return ShardingPlan()
    if isinstance(mesh, Mesh):
        lm_device(mesh)
    axis_names = tuple(mesh.axis_names)
    model = "model" if "model" in axis_names else None
    n_model = int(mesh.shape["model"]) if model else 1
    data_axes = tuple(a for a in axis_names if a != "model")
    da = _data_entry(data_axes)
    n_data = int(np.prod([mesh.shape[a] for a in data_axes] or [1]))

    H, KV = cfg.num_heads, cfg.num_kv_heads
    tp_ok = (model is not None and H > 0
             and H % n_model == 0 and KV % n_model == 0)
    attn_mode = "tp" if tp_ok else "cp"
    if attn_mode == "tp":
        hidden = P(da, None, model)
        qkv = P(da, None, model, None)
        kv_ctx = P(da, None, model, None)
    else:
        hidden = P(da, model, None)
        qkv = P(da, model, None, None)
        kv_ctx = P(da, None, None, None)      # replicated K/V: the CP gather

    small_batch = decode_batch is not None and decode_batch < n_data
    if small_batch:
        every = data_axes + ((model,) if model else ())
        decode_hidden = P(None, None, None)
        decode_cache = P(None, every if len(every) > 1 else every[0],
                         None, None)
    else:
        decode_hidden = P(da, None, None)
        decode_cache = (P(da, None, model, None) if attn_mode == "tp"
                        else P(da, model, None, None))

    try:
        ssm_heads = int(cfg.ssm_heads)
    except Exception:                         # noqa: BLE001 (reference's)
        ssm_heads = 0
    h_entry = model if (model and ssm_heads and ssm_heads % n_model == 0) \
        else None
    ssm_state = P(None if small_batch else da, h_entry, None, None)
    return ShardingPlan(
        mesh=mesh, attn_mode=attn_mode, data_axes=data_axes,
        model_axis=model, hidden=hidden, decode_hidden=decode_hidden,
        qkv=qkv, kv_ctx=kv_ctx, decode_cache=decode_cache,
        ssm_state=ssm_state)


def _shape(leaf) -> tuple:
    return tuple(getattr(leaf, "shape", ()))


def param_specs(tree, mesh):
    """PartitionSpec tree for a parameter (or optimizer-state) tree of
    nested dicts: leaves need only ``.shape`` (meta tensors allocate
    nothing).  The reference's rules: leaves of rank <= 1 or under
    ``_MIN_SHARD_SIZE`` elements replicated; the stacked-blocks dim never
    sharded; MoE expert tensors' expert dim over ``model`` and d_model over
    ``data``; else the last dim over ``model`` and the one before over
    ``data``, each only where the axis divides it."""
    axis_names = tuple(getattr(mesh, "axis_names", ()))
    n_model = int(mesh.shape["model"]) if "model" in axis_names else 0
    n_data = int(mesh.shape["data"]) if "data" in axis_names else 0

    def one(path, leaf):
        shape = _shape(leaf)
        ndim = len(shape)
        if ndim <= 1 or int(np.prod(shape)) < _MIN_SHARD_SIZE:
            return P()
        keys = [str(k) for k in path]
        name = keys[-1] if keys else ""
        first = 1 if (keys and keys[0] in _STACKED_COLLECTIONS) else 0
        spec: list = [None] * ndim
        if (ndim - first >= 3 and len(keys) >= 2 and keys[-2] == "moe"
                and name in ("wi", "wg", "wo")):
            e_dim = ndim - 3
            if n_model and shape[e_dim] % n_model == 0 and e_dim >= first:
                spec[e_dim] = "model"
            if n_data and shape[e_dim + 1] % n_data == 0:
                spec[e_dim + 1] = "data"
            return P(*spec)
        if n_model and shape[-1] % n_model == 0 and ndim - 1 >= first:
            spec[-1] = "model"
        if n_data and shape[-2] % n_data == 0 and ndim - 2 >= first:
            spec[-2] = "data"
        return P(*spec)

    return tree_map_with_path(one, tree)


def batch_specs(plan: ShardingPlan) -> dict[str, P]:
    """Input-batch specs (tokens / labels [B, S], frames [B, S, D])."""
    if plan.mesh is None:
        return {"tokens": P(), "labels": P(), "frames": P()}
    da = _data_entry(plan.data_axes)
    return {"tokens": P(da, None), "labels": P(da, None),
            "frames": P(da, None, None)}


def cache_specs(caches, plan: ShardingPlan):
    """Spec tree for a decode-cache tree, matched to each leaf's TRAILING
    dims (stacked ``[nB, B, ...]`` and unstacked ``[B, ...]`` alike; the
    leading stack dims unsharded)."""
    def one(path, leaf):
        ndim = len(_shape(leaf))
        name = str(path[-1]) if path else ""
        if name == "index" or ndim < 2 or plan.mesh is None:
            return P()
        if name in ("k", "v") and ndim >= 4:
            return P(*((None,) * (ndim - 4) + tuple(plan.decode_cache)))
        if name == "state" and ndim >= 4:
            return P(*((None,) * (ndim - 4) + tuple(plan.ssm_state)))
        if name in ("conv", "memory") and ndim >= 3:
            return P(*((None,) * (ndim - 3)
                       + (plan.decode_hidden[0], None, None)))
        return P()

    return tree_map_with_path(one, caches)


def tree_named(mesh, spec_tree):
    """Spec tree -> tree of placements (``NamedSharding``)."""
    return tree_map(lambda s: NamedSharding(mesh, s), spec_tree)
