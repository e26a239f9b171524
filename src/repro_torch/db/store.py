"""The tensor-block store: netsDB's native storage, device tier (torch).

Mirrors the device tier of ``repro/db/store.py``.  Paper Sec. 3.1: the
input samples are stored as a collection of tensor blocks.  A stored
dataset is ONE tensor [N_padded, F] on the store's device, laid out as
``page_rows``-row pages; the tail is padded to whole pages with NaN rows,
which the scan scores and then cuts off.  Pages are the batching unit
(paper F3): a batch is a contiguous page range, and batch k always covers
the same rows.

"In-database inference" = the query plan consumes these device tensors
directly, with no parse, convert or transfer on the query path.

Not ported yet: the host and disk tiers and ``move`` (ROADMAP queue 1,
item 6), CSR pages (item 7), labels for training (item 11), the
optimizer's decision catalog (item 10).
"""

from __future__ import annotations

import dataclasses
import time
import weakref
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import resolve_device

__all__ = ["StoredDataset", "TensorBlockStore"]


@dataclasses.dataclass
class StoredDataset:
    name: str
    data: torch.Tensor            # [N_padded, F] on the store's device
    num_rows: int                 # true N (pre-padding)
    page_rows: int
    task: str = "classification"
    created_at: float = dataclasses.field(default_factory=time.time)
    storage_format: str = "dense"
    tier: str = "device"

    @property
    def num_features(self) -> int:
        return self.data.shape[1]

    @property
    def num_pages(self) -> int:
        return self.data.shape[0] // self.page_rows

    @property
    def nbytes(self) -> int:
        return self.data.nbytes

    def page_slice(self, first_page: int, num_pages: int) -> torch.Tensor:
        """[num_pages * page_rows, F] contiguous page range, a view."""
        lo = first_page * self.page_rows
        return self.data[lo: lo + num_pages * self.page_rows]

    def to_device(self, block: torch.Tensor) -> torch.Tensor:
        """Scan staging: the device tier's transfer is a no-op."""
        return block


def _check_tier(tier: str) -> None:
    if tier not in ("device", "auto"):
        raise NotImplementedError(
            f"tier {tier!r} is not ported yet: the host and disk tiers are "
            f"ROADMAP queue 1, item 6")


class TensorBlockStore:
    """Catalog of device-resident datasets and pinned models.

    ``device``: where datasets live -- the card unless ``"cpu"`` is passed
    (raises with no card).
    """

    def __init__(self, device: str | torch.device | None = None, *,
                 default_page_rows: int = 1024):
        self.device = resolve_device(device)
        self.default_page_rows = default_page_rows
        self._datasets: dict[str, StoredDataset] = {}
        self._models: dict[str, dict[str, Any]] = {}
        # engines register invalidate_dataset / invalidate (weakly) so a
        # drop or a model re-pin sweeps the compiled plans built on it
        self._invalidators: list[weakref.ref] = []
        self._model_invalidators: list[weakref.ref] = []

    # -- ingestion ----------------------------------------------------------
    def put(self, name: str, data: np.ndarray | torch.Tensor, *,
            page_rows: int | None = None, task: str = "classification",
            tier: str = "device") -> StoredDataset:
        """Ingest [N, F] dense rows onto the device, padded to whole pages
        with NaN rows (never counted in results), and register them."""
        _check_tier(tier)
        page_rows = page_rows or self.default_page_rows
        src = torch.as_tensor(data)
        if src.dim() != 2:
            raise ValueError(f"expected [N, F] rows, got {tuple(src.shape)}")
        n, F = src.shape
        total = n + (-n) % page_rows
        stored = torch.empty((total, F), dtype=torch.float32,
                             device=self.device)
        stored[:n].copy_(src)
        stored[n:] = float("nan")
        ds = StoredDataset(name=name, data=stored, num_rows=n,
                           page_rows=page_rows, task=task)
        self._datasets[name] = ds
        return ds

    def put_result(self, name: str, result: torch.Tensor,
                   num_rows: int) -> StoredDataset:
        """The WRITE operator's sink: register an output dataset."""
        data = result[:, None] if result.dim() == 1 else result
        ds = StoredDataset(name=name, data=data.to(self.device),
                           num_rows=num_rows,
                           page_rows=self.default_page_rows)
        self._datasets[name] = ds
        return ds

    # -- catalog --------------------------------------------------------------
    def get(self, name: str) -> StoredDataset:
        try:
            return self._datasets[name]
        except KeyError:
            raise KeyError(f"dataset {name!r} not in store; "
                           f"have {sorted(self._datasets)}") from None

    def __contains__(self, name: str) -> bool:
        return name in self._datasets

    def catalog(self) -> dict[str, dict[str, Any]]:
        return {n: dict(rows=d.num_rows, features=d.num_features,
                        pages=d.num_pages, page_rows=d.page_rows,
                        bytes=d.nbytes, task=d.task,
                        format=d.storage_format, tier=d.tier)
                for n, d in self._datasets.items()}

    @staticmethod
    def _weak(fn: Callable) -> weakref.ref:
        return weakref.WeakMethod(fn) if hasattr(fn, "__self__") \
            else weakref.ref(fn)

    def register_invalidator(self, fn: Callable[[str], int]) -> None:
        """Register (weakly) a per-dataset invalidation hook."""
        self._invalidators.append(self._weak(fn))

    def register_model_invalidator(self, fn: Callable[[str], int]) -> None:
        """Register (weakly) a per-model-fingerprint invalidation hook."""
        self._model_invalidators.append(self._weak(fn))

    @staticmethod
    def _call_hooks(refs: list[weakref.ref], arg: str) -> int:
        n = 0
        for ref in list(refs):
            fn = ref()
            if fn is None:
                refs.remove(ref)
            else:
                n += int(fn(arg) or 0)
        return n

    def drop(self, name: str) -> int:
        """Drop a dataset AND sweep the compiled plans built against it
        (their batch signatures came from it).  Returns entries swept."""
        if self._datasets.pop(name, None) is None:
            return 0
        return self._call_hooks(self._invalidators, name)

    # -- model catalog --------------------------------------------------------
    def put_model(self, name: str, forest, **meta) -> dict[str, Any]:
        """Pin a forest under ``name``.  Re-pinning a name with another
        forest sweeps the replaced forest's compiled plans."""
        old = self._models.get(name)
        entry = dict(forest=forest, trees=int(forest.num_trees),
                     depth=int(forest.depth),
                     features=int(forest.n_features),
                     model_type=forest.model_type, task=forest.task,
                     created_at=time.time(), **meta)
        self._models[name] = entry
        if old is not None and old["forest"] is not forest:
            old_fp = old.get("fingerprint")
            if old_fp is None:
                from repro_torch.core.reuse import fingerprint_forest
                old_fp = fingerprint_forest(old["forest"])
            self._call_hooks(self._model_invalidators, old_fp)
        return entry

    def get_model(self, name: str):
        try:
            return self._models[name]["forest"]
        except KeyError:
            raise KeyError(f"model {name!r} not in store; "
                           f"have {sorted(self._models)}") from None

    def model_catalog(self) -> dict[str, dict[str, Any]]:
        return {n: {k: v for k, v in e.items() if k != "forest"}
                for n, e in self._models.items()}
