"""Model reuse: materialize once, reuse across queries (torch).

Mirrors ``repro/core/reuse.py``.  ``ModelReuseCache`` is a keyed LRU of
materializations -- the relation-centric plan's partitioned model, or a
whole compiled query plan -- so a steady-state query skips the work that
depends only on the model and the batch signature (paper Sec. 3.3,
netsDB-OPT).

Cache keys carry ``mesh_signature``: the single device (1), or a mesh's
content (axis names, shape and the device at each position), so one model
on two meshes gives two entries and a signature never outlives its mesh's
identity the way an ``id()`` could.
"""

from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Any, Callable

__all__ = ["MaterializedModel", "ModelReuseCache", "fingerprint_forest",
           "mesh_signature"]


def mesh_signature(mesh=None) -> tuple | int:
    """Cache-key component for the device layout: 1 for one device, else
    the mesh's content (reference ``repro/core/reuse.py:32-38``, whose
    mesh-less value is 0)."""
    if mesh is None:
        return 1
    return (tuple(mesh.axis_names), tuple(mesh.devices.shape),
            tuple(str(d) for d in mesh.devices.flat))


def fingerprint_forest(forest) -> str:
    """Content hash of the forest's arrays + static metadata."""
    h = hashlib.sha1()
    for name, arr in sorted(forest.arrays().items()):
        h.update(name.encode())
        h.update(arr.detach().cpu().contiguous().numpy().tobytes())
    h.update(f"{forest.depth}|{forest.n_features}|{forest.model_type}|"
             f"{forest.task}|{forest.base_score}".encode())
    return h.hexdigest()


@dataclasses.dataclass
class MaterializedModel:
    """The output of the model-partitioning stage, device-resident."""

    forest: Any                      # padded, device-resident Forest
    true_num_trees: int              # pre-padding count (MEAN aggregation)
    aux: dict[str, Any]              # algorithm side tensors
    build_time_s: float = 0.0        # the cost model reuse amortizes away


@dataclasses.dataclass
class _Stats:
    hits: int = 0
    misses: int = 0
    build_time_s: float = 0.0
    saved_time_s: float = 0.0


class ModelReuseCache:
    """Keyed materialization cache with LRU eviction.

    Generic over the entry type: anything with a mutable ``build_time_s``
    attribute can be cached.  A hit refreshes the key's recency.
    """

    def __init__(self, max_entries: int = 32):
        self._entries: dict[tuple, Any] = {}
        self._order: list[tuple] = []
        self._max = max_entries
        self.stats = _Stats()

    def get_or_build(self, key: tuple, build: Callable[[], Any]) -> Any:
        entry = self._entries.get(key)
        if entry is not None:
            self.stats.hits += 1
            self.stats.saved_time_s += entry.build_time_s
            self._order.remove(key)
            self._order.append(key)
            return entry
        self.stats.misses += 1
        t0 = time.perf_counter()
        entry = build()
        entry.build_time_s = time.perf_counter() - t0
        self.stats.build_time_s += entry.build_time_s
        self._entries[key] = entry
        self._order.append(key)
        while len(self._order) > self._max:
            self._entries.pop(self._order.pop(0), None)
        return entry

    def invalidate(self, model_id: str | None = None, *,
                   key_index: int = 0) -> int:
        """Drop every entry, or those whose ``key[key_index]`` equals
        ``model_id`` (0 for model keys, 1 for plan keys, 2 to match the
        dataset slot of a plan key).  Returns the count dropped."""
        if model_id is None:
            n = len(self._entries)
            self._entries.clear()
            self._order.clear()
            return n
        victims = [k for k in self._order
                   if len(k) > key_index and k[key_index] == model_id]
        for k in victims:
            self._entries.pop(k, None)
            self._order.remove(k)
        return len(victims)

    def __len__(self) -> int:
        return len(self._entries)
