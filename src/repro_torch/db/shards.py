"""Row shards of a page batch over a mesh's ``data`` axis (torch).

The scan's half of the mesh (``dist/sharding.py`` holds the axis
mapping): the store's ``data_sharding()`` is a ``RowSharding``, which the
executor uses to split each loaded batch into ``RowShards``, one
contiguous row shard a data position, each on its home device.  The
stages map their per-shard work over the shards (``map_shards``), and a
plan's last stage gathers its per-shard predictions at the store's device
in row order (``map_gathered``), so the drain sees one ``[B]`` tensor, as
it does off-mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.db.sparse import CSRPages
from repro_torch.dist.sharding import physical

__all__ = ["RowSharding", "RowShards", "device_of", "place", "map_shards",
           "map_gathered", "row_offsets", "to_host"]


def device_of(block) -> torch.device:
    """The device of a tensor or of a CSR page block's arrays."""
    return block.tensors()[0].device if isinstance(block, CSRPages) \
        else block.device


def place(block, device: torch.device):
    """``block`` (a tensor, or a CSR page block) on ``device``: itself when
    it is there already, else a copy."""
    if physical(device_of(block)) == physical(device):
        return block
    if isinstance(block, CSRPages):
        return block.replace(tuple(a.to(device, non_blocking=True)
                                   for a in block.tensors()), tier="device")
    return block.to(device, non_blocking=True)


@dataclasses.dataclass
class RowShards:
    """A batch split over the ``data`` axis, in row order: ``parts[d]`` is
    data shard d (a tensor, or a CSR page block) on its home device."""

    parts: list

    def map(self, fn: Callable[[int, Any], Any]) -> "RowShards":
        """``fn(d, part)`` on every shard, in data order."""
        return RowShards([fn(d, p) for d, p in enumerate(self.parts)])

    def tensors(self) -> list[torch.Tensor]:
        out: list[torch.Tensor] = []
        for p in self.parts:
            out.extend(p.tensors() if isinstance(p, CSRPages) else (p,))
        return out


def _parts(value) -> list:
    return value.parts if isinstance(value, RowShards) else [value]


def map_shards(value, fn: Callable[[Any], Any]):
    """``fn`` on every row shard of a stage value, in row order (on the
    value itself when it is not sharded)."""
    if isinstance(value, RowShards):
        return value.map(lambda _, part: fn(part))
    return fn(value)


def map_gathered(value, fn: Callable[[torch.Tensor], torch.Tensor],
                 home: torch.device) -> torch.Tensor:
    """``fn`` once over a row-sharded [rows] value's shards gathered at
    ``home`` in row order; ``fn(value)`` for an unsharded one.  Phase 2
    (``postprocess``) runs this way, once a batch as over the reference's
    global output: on the CPU, PyTorch's elementwise kernels take a vector
    path for whole vectors and a scalar one for the tail, so a sigmoid
    over a small shard and over the whole batch can differ in the last
    bit."""
    if not isinstance(value, RowShards):
        return fn(value)
    return fn(torch.cat([place(p, home) for p in value.parts]))


def row_offsets(value) -> list[tuple[int, Any]]:
    """(first row, shard) of every row shard of a dense stage value."""
    out, off = [], 0
    for part in _parts(value):
        out.append((off, part))
        off += part.shape[0]
    return out


def to_host(value) -> np.ndarray:
    """A stage value's rows as one host array, shards stitched in order."""
    return np.concatenate([p.cpu().numpy() for p in _parts(value)])


@dataclasses.dataclass(frozen=True)
class RowSharding:
    """How a page batch is laid over the ``data`` axis: rows split into
    ``len(devices)`` equal contiguous shards, shard d on ``devices[d]``
    (the store's ``data_sharding``; the reference's ``P("data", None)``)."""

    devices: tuple[torch.device, ...]

    def split(self, block) -> RowShards:
        """A [rows, ...] tensor or a CSR page block as ``RowShards``: views
        of ``block`` where a shard's home is the block's device, copies
        elsewhere.  The row (page) count must divide the axis."""
        n = len(self.devices)
        csr = isinstance(block, CSRPages)
        units = block.num_pages if csr else block.shape[0]
        if units % n:
            raise ValueError(f"{units} {'pages' if csr else 'rows'} do not "
                             f"divide the data axis ({n})")
        per = units // n
        parts = []
        for d, dev in enumerate(self.devices):
            part = (block.page_slice(d * per, per) if csr
                    else block[d * per:(d + 1) * per])
            parts.append(place(part, dev))
        return RowShards(parts)
