"""The tensor-block store: netsDB's native storage, tiered (torch).

Mirrors the dense half of ``repro/db/store.py``.  Paper Sec. 3.1: the
input samples are stored as a collection of tensor blocks.  A stored
dataset is ONE array [N_padded, F] laid out as ``page_rows``-row pages;
the tail is padded to whole pages with NaN rows, which the scan scores
and then cuts off.  Pages are the batching unit (paper F3): a batch is a
contiguous page range, and batch k always covers the same rows.

A sparse dataset (``put_sparse``, ``SparseStoredDataset``) holds CSR
pages instead (``db/sparse.py``): three page arrays -- ``indptr``,
``indices``, ``values`` -- with the same page <-> batch determinism, on
the same tiers, where a rung holds three arrays (three pinned tensors,
three spill files).

Every dataset lives on one rung of the TIER LADDER:

  ``device``  a tensor on the store's device, consumed by the kernels
              with no staging ("in-database inference": no parse, convert
              or transfer on the query path);
  ``host``    a CPU tensor in PINNED memory on a CUDA store, so that the
              scan's page copies to the card are truly asynchronous
              (plain CPU memory only on a store made with
              ``device="cpu"``; on a CUDA store a failed pin raises);
  ``disk``    a page-aligned raw ``np.memmap`` file under the store's
              ``spill_dir``.  Its ``page_slice`` is a lazy memmap view:
              only the pages a batch touches are read.

``put(tier="auto")`` walks the ladder top-down: an ingest that would push
the device-resident total past ``device_budget_bytes`` spills to host,
and one that would also push the host-resident total past
``host_budget_bytes`` spills to disk (no budget: the device).  ``move``
migrates a dataset between any two tiers with the page layout unchanged
and rolls back on failure; ``drop`` deletes the spill files the store
wrote.  Each dataset is a ``ScanSource`` for the streaming executor
(``page_slice`` in its own tier, ``to_device`` staging), so no caller
branches on where pages live.

``put``, ``put_sparse`` and ``stream_writer`` take the rows' ``labels``,
kept as f32 [N] on the store's device (reference ``repro/db/store.py:
_put_impl`` / ``put_sparse`` / ``stream_writer``).  ``stream_writer`` also
takes the relation's ``dtype`` and the ``fill`` of its page-alignment
tail: the trainer's bins relation is uint8, padded with the MISSING bin,
and counts its uint8 bytes in the tier cascade (``db/train.py``).

The decision catalog (reference ``store.py:779-809``): the cost-based
optimizer (``db/optimizer.py``) persists its verdicts here, keyed (model
fingerprint, dataset name or the ``"#rows"`` sentinel, dataset signature,
mesh signature, candidate sets).  They are swept on the events that sweep
compiled plans: ``drop``, a re-``put`` / re-``put_sparse`` / an opened
``stream_writer`` of the name, and ``put_model`` replacing a forest (the
old fingerprint's decisions).

Faults (``db/faults.py``, reference ``store.py:258-270, 642-728``): a store
made with ``injector=`` / ``retry_policy=`` reads each page array off the
disk tier in ``move`` through the ``disk_page_read`` site, one guarded
call an array (three for CSR); an exhausted read rolls the move back and
raises ``ScanFault("disk_page_read", rows_completed=0)``.  The scan's own
sites are the executor's.

The mesh (reference ``store.py:349-366``): a store made with ``mesh=``
pads every ingest (``put``, ``put_sparse``, ``stream_writer`` /
``put_stream``, and ``put_result``) to a page count that the mesh's
``data`` axis divides (``data_axis_size``), so any batch of whole data
units splits evenly into row shards; ``data_sharding()`` is that split.
The device tier keeps ONE copy of a table, on the store's device (the home
of data shard 0 unless ``device`` says otherwise), and the scan places each
batch's row shards (``db/executor.py``): views where a shard's home is that
device, as on a mesh of repeated positions, copies elsewhere.  The
reference keeps a device-tier table sharded over ``data`` and replicated
over ``model``; on one card the two layouts are the same bytes, and a
mesh of distinct cards is not measured yet (ROADMAP).

Tracing (``repro_torch.obs``, reference ``store.py:407-475, 637-640,
952-975``): every ingest is one ``store.put`` (``put``, a
``stream_writer``'s ``close`` with ``streamed=True``) or
``store.put_sparse`` span with the RESOLVED tier as its ``tier`` attr,
and counts ``store.puts``; ``move`` is a ``store.move`` span with ``src`` /
``dst`` attrs and counts ``store.moves`` per attempt, a rolled-back move
included.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import re
import tempfile
import time
import weakref
from typing import Any, Callable, Iterable

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.db.faults import (FaultInjector, InjectedFault,
                                   RetryPolicy, ScanFault)
from repro_torch.db.sparse import (CSRPages, csr_from_dense, pad_pages,
                                   paginate_csr)
from repro_torch.db.shards import RowSharding
from repro_torch.dist.sharding import Mesh, make_forest_plan
from repro_torch.obs import METRICS, TRACER

__all__ = ["StoredDataset", "SparseStoredDataset", "TensorBlockStore",
           "DenseStreamWriter", "mmap_array", "TIERS"]

#: the tier ladder, fastest first; the ``auto`` cascade walks it top-down
TIERS = ("device", "host", "disk")

#: a CSR dataset's page arrays, in ``CSRPages.arrays()`` order (and the
#: labels of their spill files)
CSR_ARRAYS = ("indptr", "indices", "values")


def _check_tier(tier: str) -> str:
    if tier not in TIERS:
        raise ValueError(f"unknown tier {tier!r}; expected one of {TIERS}")
    return tier


def _host_rows(data) -> torch.Tensor:
    """A tier's array as a tensor: a memmap as a tensor over the mapping
    (no copy), a tensor as itself."""
    return torch.from_numpy(data) if isinstance(data, np.ndarray) else data


def mmap_array(path: str, arr: np.ndarray | torch.Tensor) -> np.memmap:
    """Write ``arr`` (numpy, or a tensor on any device) to ``path`` as a
    raw page-aligned memory-mapped file and return the live map.

    Raw (headerless) layout at offset 0, C-contiguous: store page ``p``
    occupies bytes ``[p * page_nbytes, (p+1) * page_nbytes)``, so a page
    view reads only that range.  An existing file is unlinked first, never
    truncated in place: truncating a mapped file SIGBUSes readers of the
    old map, and the unlinked inode stays alive for them.  A write that
    fails removes its partial file."""
    if os.path.exists(path):
        os.unlink(path)
    src = _host_rows(arr)
    dtype = torch.empty(0, dtype=src.dtype).numpy().dtype
    mm = np.memmap(path, dtype=dtype, mode="w+", shape=tuple(src.shape))
    try:
        torch.from_numpy(mm).copy_(src)
        mm.flush()
    except BaseException:
        del mm
        os.unlink(path)
        raise
    return mm


@dataclasses.dataclass
class StoredDataset:
    name: str
    data: Any                     # [N_padded, F]: a tensor on the store's
    #                               device (device tier), a CPU tensor,
    #                               pinned on a CUDA store (host tier), or
    #                               an np.memmap (disk tier)
    num_rows: int                 # true N (pre-padding)
    page_rows: int
    device: torch.device = torch.device("cpu")   # the store's device
    task: str = "classification"
    created_at: float = dataclasses.field(default_factory=time.time)
    storage_format: str = "dense"
    tier: str = "device"
    labels: torch.Tensor | None = None   # f32 [N] on the store's device

    @property
    def num_features(self) -> int:
        return self.data.shape[1]

    @property
    def num_pages(self) -> int:
        return self.data.shape[0] // self.page_rows

    @property
    def nbytes(self) -> int:
        return self.data.nbytes

    @property
    def page_nbytes(self) -> int:
        """Bytes of ONE page: the unit the streaming scan budgets."""
        return self.nbytes // max(self.num_pages, 1)

    @property
    def dtype(self) -> torch.dtype:
        return _host_rows(self.data[:0]).dtype

    @property
    def pageable(self) -> bool:
        """Pages that a copy to the card cannot read asynchronously (the
        disk tier's mapping): the scan stages them through pinned buffers."""
        return self.tier == "disk"

    def page_slice(self, first_page: int, num_pages: int):
        """[num_pages * page_rows, F] contiguous page range, a VIEW in the
        dataset's own tier: a device or host tensor view, or an np.memmap
        view that reads only the pages it covers."""
        lo = first_page * self.page_rows
        return self.data[lo: lo + num_pages * self.page_rows]

    def empty_block(self, num_pages: int, *, device=None,
                    pin_memory: bool = False) -> torch.Tensor:
        """An uninitialised block of ``num_pages`` pages: a scan's page
        buffer on ``device``, or its pinned staging buffer."""
        shape = (num_pages * self.page_rows, self.num_features)
        if device is None:
            return torch.empty(shape, dtype=self.dtype,
                               pin_memory=pin_memory)
        return torch.empty(shape, dtype=self.dtype, device=device)

    def first_pages(self, block: torch.Tensor,
                    num_pages: int) -> torch.Tensor:
        """The first ``num_pages`` pages of a block, a view."""
        return block[: num_pages * self.page_rows]

    def read_pages(self, block, out: torch.Tensor) -> torch.Tensor:
        """Read a page block into the host buffer ``out`` (the disk tier's
        pinned staging): for a memmap view, the real read of its pages."""
        return out.copy_(_host_rows(block))

    def to_device(self, block, out: torch.Tensor) -> torch.Tensor:
        """ScanSource staging on the current stream: ``block`` (the host
        tier's pinned pages, or the disk tier's staged ones) is copied into
        the device page buffer ``out``, non-blocking, which is asynchronous
        from pinned memory."""
        return out.copy_(_host_rows(block), non_blocking=True)


@dataclasses.dataclass
class SparseStoredDataset:
    """A CSR-paged dataset: the sparse plane's ``StoredDataset``.

    The same page <-> batch determinism (a batch is a contiguous page
    range, every page block has one shape); pages past ``num_rows`` are
    EMPTY rows (every feature missing), the dense store's NaN rows.  A
    ``ScanSource`` on every tier: its blocks are ``CSRPages`` of three
    arrays, and ``to_device`` stages all three."""

    name: str
    pages: CSRPages
    num_rows: int                 # true N (pre-padding)
    device: torch.device = torch.device("cpu")   # the store's device
    task: str = "classification"
    created_at: float = dataclasses.field(default_factory=time.time)
    storage_format: str = "csr"
    tier: str = "device"
    labels: torch.Tensor | None = None   # f32 [N] on the store's device

    @property
    def num_features(self) -> int:
        return self.pages.n_features

    @property
    def page_rows(self) -> int:
        return self.pages.page_rows

    @property
    def num_pages(self) -> int:
        return self.pages.num_pages

    @property
    def nbytes(self) -> int:
        return self.pages.nbytes

    @property
    def page_nbytes(self) -> int:
        """Bytes of ONE page (all three arrays): the streaming unit."""
        return self.nbytes // max(self.num_pages, 1)

    @property
    def pageable(self) -> bool:
        return self.tier == "disk"

    @property
    def nnz(self) -> int:
        """Stored entries, capacity padding excluded."""
        return int(self.pages.tensors()[0][:, -1].sum())

    def page_slice(self, first_page: int, num_pages: int) -> CSRPages:
        """A contiguous page range, a view in the dataset's own tier."""
        return self.pages.page_slice(first_page, num_pages)

    def empty_block(self, num_pages: int, *, device=None,
                    pin_memory: bool = False) -> CSRPages:
        """Uninitialised page arrays for ``num_pages`` pages: a scan's
        page buffers on ``device``, or its pinned staging buffers."""
        R, C = self.page_rows, self.pages.capacity
        specs = (((num_pages, R + 1), torch.int32),
                 ((num_pages, C), torch.int32),
                 ((num_pages, C), torch.float32))
        if device is None:
            arrays = tuple(torch.empty(shape, dtype=dt, pin_memory=pin_memory)
                           for shape, dt in specs)
            return self.pages.replace(arrays, tier="host")
        arrays = tuple(torch.empty(shape, dtype=dt, device=device)
                       for shape, dt in specs)
        return self.pages.replace(arrays, tier="device")

    def first_pages(self, block: CSRPages, num_pages: int) -> CSRPages:
        return block.page_slice(0, num_pages)

    def read_pages(self, block: CSRPages, out: CSRPages) -> CSRPages:
        """``StoredDataset.read_pages`` for each of the three arrays."""
        for dst, src in zip(out.tensors(), block.tensors()):
            dst.copy_(src)
        return out

    def to_device(self, block: CSRPages, out: CSRPages) -> CSRPages:
        """``StoredDataset.to_device`` for each of the three arrays."""
        for dst, src in zip(out.tensors(), block.tensors()):
            dst.copy_(src, non_blocking=True)
        return out


class TensorBlockStore:
    """Catalog of tiered datasets and pinned models.

    ``device``: where queries compute -- the card unless ``"cpu"`` is
    passed (raises with no card).  ``mesh``: a ``dist.sharding.Mesh`` whose
    ``data`` axis the store pads and shards page batches over (module
    note); its device type must be the store's, and ``device`` defaults to
    the home of data shard 0.  ``device_budget_bytes`` /
    ``host_budget_bytes``: soft caps on the device- and host-resident
    totals that steer ``tier="auto"`` ingests down the ladder.
    ``spill_dir``: where disk-tier page files go (a new temporary
    directory at the first spill when None).  ``injector`` /
    ``retry_policy``: the ``disk_page_read`` site of ``move`` off the disk
    tier (an armed injector with no policy gets ``RetryPolicy()``).
    """

    def __init__(self, device: str | torch.device | None = None, *,
                 mesh: Mesh | None = None,
                 default_page_rows: int = 1024,
                 device_budget_bytes: int | None = None,
                 host_budget_bytes: int | None = None,
                 spill_dir: str | None = None,
                 injector: FaultInjector | None = None,
                 retry_policy: RetryPolicy | None = None):
        self.mesh = mesh
        self.fplan = make_forest_plan(mesh)
        if mesh is not None and device is None:
            device = self.fplan.position(0, 0)
        self.device = resolve_device(device)
        if mesh is not None and mesh.device_type != self.device.type:
            raise ValueError(f"a store on {self.device} cannot take a mesh "
                             f"of {mesh.device_type} positions")
        self.default_page_rows = default_page_rows
        self.device_budget_bytes = device_budget_bytes
        self.host_budget_bytes = host_budget_bytes
        self.injector = injector
        self.retry_policy = retry_policy if retry_policy is not None \
            else (RetryPolicy() if injector is not None else None)
        self._spill_dir = spill_dir
        # spill files THIS store wrote, per dataset
        self._disk_paths: dict[str, list[str]] = {}
        self._datasets: dict[str, StoredDataset] = {}
        self._models: dict[str, dict[str, Any]] = {}
        # engines register invalidate_dataset / invalidate (weakly) so a
        # drop or a model re-pin sweeps the compiled plans built on it
        self._invalidators: list[weakref.ref] = []
        self._model_invalidators: list[weakref.ref] = []
        # persisted optimizer decisions (module note)
        self._decisions: dict[tuple, Any] = {}

    # -- the mesh -----------------------------------------------------------
    @property
    def data_axis_size(self) -> int:
        """The mesh's ``data``-axis size (1 off-mesh): every ingest pads its
        page count to a multiple of it."""
        return self.fplan.n_data

    def data_sharding(self) -> RowSharding | None:
        """Row shards of a page batch over ``data``, each on its home
        device (None off-mesh, or on a mesh with no data axis)."""
        if self.fplan.data_axis is None:
            return None
        return RowSharding(self.fplan.data_devices)

    # -- disk-tier spill files ----------------------------------------------
    @property
    def spill_dir(self) -> str:
        """Directory of this store's disk-tier page files (created at the
        first use: a store that never spills touches no filesystem)."""
        if self._spill_dir is None:
            self._spill_dir = tempfile.mkdtemp(prefix="tbstore-disk-")
        return self._spill_dir

    def _disk_path(self, name: str, label: str) -> str:
        """Spill-file path for one page array.  The file name carries a
        short digest of the raw dataset name: sanitising is lossy ("a/b"
        and "a:b" both become "a_b"), and two datasets sharing a path
        would unlink each other's files."""
        digest = hashlib.blake2s(name.encode(), digest_size=4).hexdigest()
        stem = f"{re.sub(r'[^A-Za-z0-9._@+-]', '_', name)}-{digest}"
        return os.path.join(self.spill_dir, f"{stem}.{label}.bin")

    def _track(self, name: str, label: str) -> str:
        """Reserve and track a spill path before anything is written to
        it, so a failed write is swept like a finished one."""
        path = self._disk_path(name, label)
        self._disk_paths.setdefault(name, []).append(path)
        return path

    def _disk_array(self, name: str, label: str, arr) -> np.memmap:
        """Spill one page array to ``spill_dir`` and track the file."""
        return mmap_array(self._track(name, label), arr)

    def _disk_empty(self, name: str, label: str, shape,
                    dtype=np.float32) -> np.memmap:
        """An EMPTY page-aligned spill file, tracked: the streamed-ingest
        target (same unlink-first rule as :func:`mmap_array`)."""
        path = self._track(name, label)
        if os.path.exists(path):
            os.unlink(path)
        return np.memmap(path, dtype=dtype, mode="w+", shape=shape)

    def _release_disk(self, name: str) -> None:
        """Delete the spill files written for ``name`` (live memmap views
        keep the unlinked inodes readable until they are collected)."""
        for path in self._disk_paths.pop(name, ()):
            try:
                os.unlink(path)
            except FileNotFoundError:
                pass

    # -- tier storage ---------------------------------------------------------
    def _host_empty(self, shape, dtype=torch.float32) -> torch.Tensor:
        """Host-tier storage: pinned on a CUDA store, where an allocation
        that comes back unpinned raises instead of quietly streaming
        synchronously."""
        pin = self.device.type == "cuda"
        out = torch.empty(shape, dtype=dtype, pin_memory=pin)
        if pin and not out.is_pinned():
            raise RuntimeError("the host tier's pages could not be pinned")
        return out

    def _relocate(self, name: str, tier: str, rows,
                  label: str = "rows") -> Any:
        """A copy of ``rows`` (a tensor on any device, or a memmap) in
        ``tier``'s storage, page layout unchanged (``label`` names its
        spill file)."""
        if tier == "disk":
            return self._disk_array(name, label, rows)
        src = _host_rows(rows)
        if tier == "host":
            return self._host_empty(tuple(src.shape), src.dtype).copy_(src)
        return src.to(self.device, copy=True)

    # -- tier accounting ----------------------------------------------------
    def _tier_nbytes(self, tier: str) -> int:
        return sum(d.nbytes for d in self._datasets.values()
                   if d.tier == tier)

    @property
    def device_nbytes(self) -> int:
        return self._tier_nbytes("device")

    @property
    def host_nbytes(self) -> int:
        return self._tier_nbytes("host")

    @property
    def disk_nbytes(self) -> int:
        return self._tier_nbytes("disk")

    def _resolve_tier(self, tier: str, ingest_nbytes: int) -> str:
        """``auto`` cascades down the ladder: past ``device_budget_bytes``
        to host, past ``host_budget_bytes`` too to disk."""
        if tier != "auto":
            return _check_tier(tier)
        if (self.device_budget_bytes is None
                or self.device_nbytes + ingest_nbytes
                <= self.device_budget_bytes):
            return "device"
        if (self.host_budget_bytes is None
                or self.host_nbytes + ingest_nbytes
                <= self.host_budget_bytes):
            return "host"
        return "disk"

    # -- ingestion ----------------------------------------------------------
    def _labels(self, labels, num_rows: int) -> torch.Tensor | None:
        """A dataset's labels as f32 [N] on the store's device."""
        if labels is None:
            return None
        lab = torch.as_tensor(labels).to(self.device, torch.float32)
        if tuple(lab.shape) != (num_rows,):
            raise ValueError(f"labels {tuple(lab.shape)} do not match "
                             f"{num_rows} rows")
        return lab

    def put(self, name: str, data: np.ndarray | torch.Tensor, *,
            labels=None, page_rows: int | None = None,
            task: str = "classification",
            tier: str = "auto") -> StoredDataset:
        """Ingest [N, F] dense rows (numpy, or a tensor on any device):
        pad to whole pages with NaN rows (never counted in results),
        resolve the tier, lay the rows out there and register them.
        ``labels`` [N], if given, are kept as f32 on the store's device."""
        page_rows = page_rows or self.default_page_rows
        with TRACER.span("store.put", dataset=name) as sp:
            src = torch.as_tensor(data)
            if src.dim() != 2:
                raise ValueError(f"expected [N, F] rows, got "
                                 f"{tuple(src.shape)}")
            n, F = src.shape
            w = self.stream_writer(name, num_rows=n, num_features=F,
                                   page_rows=page_rows, tier=tier,
                                   labels=labels, task=task)
            try:
                w.write(src)
            except BaseException:
                w.abort()
                raise
            ds = w._register()
            sp.set(tier=ds.tier)
        METRICS.counter("store.puts").inc()
        return ds

    def _pages_on(self, pages: CSRPages, tier: str) -> bool:
        """Whether page arrays already sit in ``tier``'s storage of this
        store (a ``put_sparse(pages=)`` handoff there is zero-copy)."""
        arrays = pages.arrays()
        if tier == "disk":
            return all(isinstance(a, np.memmap) for a in arrays)
        if any(isinstance(a, np.ndarray) for a in arrays):
            return False
        if tier == "device":
            return all(a.device.type == self.device.type for a in arrays)
        pinned = self.device.type != "cuda"
        return all(a.device.type == "cpu" and (pinned or a.is_pinned())
                   for a in arrays)

    def _relocate_pages(self, name: str, tier: str,
                        pages: CSRPages) -> CSRPages:
        """A copy of page arrays in ``tier``'s storage (on the disk tier,
        three spill files labelled by array)."""
        return pages.replace(tuple(
            self._relocate(name, tier, a, label)
            for label, a in zip(CSR_ARRAYS, pages.arrays())), tier=tier)

    def put_sparse(self, name: str, data=None, *, csr=None,
                   num_rows: int | None = None,
                   num_features: int | None = None,
                   pages: CSRPages | None = None,
                   page_rows: int | None = None, labels=None,
                   task: str = "classification", drop_zeros: bool = False,
                   tier: str = "auto") -> SparseStoredDataset:
        """Ingest a CSR dataset (the sparse data plane), most compressed
        entry point first:

          * ``pages``: already paginated ``CSRPages`` (``num_rows``
            required); a handoff already on the resolved tier is
            registered as it is, zero-copy;
          * ``csr``: an (indptr [N+1], indices, values) triple, numpy or
            tensors (``num_rows`` and ``num_features`` required);
          * ``data``: dense rows with NaN = missing (numpy, or a tensor on
            any device), explicit zeros kept unless ``drop_zeros``.

        Rows pad to whole pages as EMPTY rows, as ``put`` pads with NaN
        rows.  The tier resolves from the pages' bytes (``auto`` cascades
        as for ``put``); the host tier holds three pinned tensors on a
        CUDA store, the disk tier three spill files.  ``labels`` [N], if
        given, are kept as f32 on the store's device."""
        with TRACER.span("store.put_sparse", dataset=name) as sp:
            page_rows = page_rows or self.default_page_rows
            self._release_disk(name)   # a re-put's old spill files go away
            self.drop_decisions(dataset=name)   # and its decisions are stale
            if pages is None:
                if csr is None:
                    if data is None:
                        raise ValueError("need one of data=, csr=, pages=")
                    x = torch.as_tensor(data)
                    if x.dim() != 2:
                        raise ValueError(f"expected [N, F] rows, got "
                                         f"{tuple(x.shape)}")
                    num_rows, num_features = x.shape
                    csr = csr_from_dense(x, drop_zeros=drop_zeros)
                if num_rows is None or num_features is None:
                    raise ValueError("num_rows and num_features are required "
                                     "with csr=")
                pages = CSRPages(*paginate_csr(
                    *csr, num_rows=int(num_rows), page_rows=page_rows,
                    n_features=int(num_features),
                    pages_multiple=self.data_axis_size),
                    n_features=int(num_features))
            elif num_rows is None:
                raise ValueError("num_rows is required with pages=")
            else:
                pages = pad_pages(pages, self.data_axis_size)
            lab = self._labels(labels, int(num_rows))
            tier = self._resolve_tier(tier, pages.nbytes)
            if self._pages_on(pages, tier):
                pages = pages.replace(pages.arrays(), tier=tier)
            else:
                pages = self._relocate_pages(name, tier, pages)
            ds = SparseStoredDataset(name=name, pages=pages,
                                     num_rows=int(num_rows),
                                     device=self.device, task=task,
                                     tier=tier, labels=lab)
            self._datasets[name] = ds
            sp.set(tier=tier)
        METRICS.counter("store.puts").inc()
        return ds

    def put_result(self, name: str, result: torch.Tensor,
                   num_rows: int) -> StoredDataset:
        """The WRITE operator's sink: register an output dataset where the
        scan left it -- on the device, or on the host tier (pinned on a
        CUDA store) for a scan over an off-device table.

        A kept divergence (ROADMAP section 3, item 3): the reference
        registers every result on the device tier
        (``repro/db/store.py:583-589``), since its scan always returns a
        device array (``repro/db/query.py:974``).  Here an off-device
        scan's result stays in host memory and counts in ``host_nbytes``,
        so a later ``put(tier="auto")`` may cascade differently."""
        data = result[:, None] if result.dim() == 1 else result
        unit = self.data_axis_size * self.default_page_rows
        if unit > self.default_page_rows and data.shape[0] % unit:
            # a mesh store's tables divide its data axis (module note)
            tail = data.new_full(((-data.shape[0]) % unit, data.shape[1]),
                                 float("nan"))
            data = torch.cat([data, tail])
        # by device type: the store's "cuda" carries no index, a result's
        # "cuda:0" does, and the two do not compare equal
        tier = "device"
        if data.device.type != self.device.type:
            tier = "host"
            if self.device.type == "cuda" and not data.is_pinned():
                data = self._relocate(name, "host", data)
        ds = StoredDataset(name=name, data=data, num_rows=num_rows,
                           page_rows=self.default_page_rows,
                           device=self.device, tier=tier)
        self._datasets[name] = ds
        return ds

    def stream_writer(self, name: str, *, num_rows: int, num_features: int,
                      dtype=torch.float32, page_rows: int | None = None,
                      tier: str = "auto", fill=float("nan"), labels=None,
                      task: str = "classification") -> "DenseStreamWriter":
        """Open a batch-by-batch dense ingest under ``name``.

        Rows arrive in order through ``write(batch)`` and land straight
        in the resolved tier's storage (on the disk tier, the mmap file),
        so the whole [N, F] array never has to exist in caller memory.
        Rows are stored as ``dtype`` (a torch dtype), the tier is
        resolved up front from the declared size in that dtype, and
        ``fill`` pads the page-alignment tail (NaN for float rows, the
        MISSING bin for a bins relation).  ``labels`` [N], if given, are
        kept as f32 on the store's device.  ``close()`` registers and
        returns the ``StoredDataset``; ``abort()`` drops what was
        written."""
        return DenseStreamWriter(self, name, num_rows=num_rows,
                                 num_features=num_features, dtype=dtype,
                                 page_rows=page_rows or self.default_page_rows,
                                 tier=tier, fill=fill,
                                 labels=self._labels(labels, num_rows),
                                 task=task)

    def put_stream(self, name: str, batches: Iterable, **kw
                   ) -> StoredDataset:
        """Ingest an iterator of [rows_i, F] batches, in row order,
        through :meth:`stream_writer` (same keywords)."""
        w = self.stream_writer(name, **kw)
        try:
            for batch in batches:
                w.write(batch)
        except BaseException:
            w.abort()
            raise
        return w.close()

    # -- tier migration -----------------------------------------------------
    def move(self, name: str, tier: str) -> StoredDataset:
        """Migrate a dataset to ``tier`` (eviction down the ladder,
        promotion up it).  The page layout is kept exactly, so every
        prediction is unchanged and compiled plans stay valid: the tier
        is a property of the scan, not of the plan.  Leaving the disk
        tier deletes the store's spill files for the dataset.

        Off the disk tier, each page array is read (and copied to its new
        tier) through the ``disk_page_read`` site under the store's retry
        policy.  On ANY exception the move rolls back -- the spill files
        it wrote are unlinked, the tracked paths restored, the catalog
        (and so the per-tier accounting) untouched; a retryable fault of
        the disk read is then raised as ``ScanFault("disk_page_read")``,
        anything else as it is."""
        src_tier = self.get(name).tier
        METRICS.counter("store.moves").inc()   # per attempt
        with TRACER.span("store.move", dataset=name, src=src_tier, dst=tier):
            _check_tier(tier)
            ds = self.get(name)
            if ds.tier == tier:
                return ds
            was_disk = ds.tier == "disk"

            def relocate(label: str, arr):
                if not was_disk:
                    return self._relocate(name, tier, arr, label)
                return self._disk_read(
                    lambda: self._relocate(name, tier, arr, label))

            paths_before = list(self._disk_paths.get(name, ()))
            try:
                if ds.storage_format == "csr":
                    new = dataclasses.replace(ds, pages=ds.pages.replace(
                        tuple(relocate(label, a) for label, a in
                              zip(CSR_ARRAYS, ds.pages.arrays())),
                        tier=tier), tier=tier)
                else:
                    new = dataclasses.replace(
                        ds, data=relocate("rows", ds.data), tier=tier)
            except BaseException as e:
                for path in self._disk_paths.get(name, ()):
                    if path not in paths_before and os.path.exists(path):
                        os.unlink(path)
                if paths_before:
                    self._disk_paths[name] = paths_before
                else:
                    self._disk_paths.pop(name, None)
                policy = self.retry_policy
                retryable = (policy.retryable if policy is not None
                             else (InjectedFault, OSError))
                if was_disk and isinstance(e, retryable):
                    raise ScanFault(
                        "disk_page_read", rows_completed=0, cause=e,
                        attempts=policy.max_attempts if policy else 1,
                        detail=f"move({name!r} -> {tier!r}) rolled back"
                    ) from e
                raise
            if ds.tier == "disk":
                self._release_disk(name)
            self._datasets[name] = new
            return new

    def _disk_read(self, read: Callable[[], Any]) -> Any:
        """``read()`` (one page array off the disk tier) through the
        ``disk_page_read`` site under the store's retry policy; a direct
        call with none (an injector always comes with one)."""
        if self.retry_policy is None:
            return read()
        return self.retry_policy.run(read, site="disk_page_read",
                                     injector=self.injector)

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
        """Every dataset's shape, bytes, tier and storage format (and, for
        CSR, its stored entries ``nnz``)."""
        out = {}
        for n, d in self._datasets.items():
            entry = dict(rows=d.num_rows, features=d.num_features,
                         pages=d.num_pages, page_rows=d.page_rows,
                         bytes=d.nbytes, task=d.task,
                         format=d.storage_format, tier=d.tier)
            if d.storage_format == "csr":
                entry["nnz"] = d.nnz
            out[n] = entry
        return out

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
        """Drop a dataset, delete the spill files the store wrote for it,
        AND sweep the optimizer decisions keyed on it and the compiled
        plans built against it (their batch signatures came from it).
        Returns entries swept (decisions + plans)."""
        existed = self._datasets.pop(name, None)
        self._release_disk(name)
        if existed is None:
            return 0
        # decisions first: the engines' hooks then find none to re-drop
        swept = self.drop_decisions(dataset=name)
        return swept + self._call_hooks(self._invalidators, name)

    # -- decision catalog (db/optimizer.py) -----------------------------------
    def put_decision(self, key: tuple, decision) -> None:
        """Persist an optimizer decision.  ``key[0]`` is the model
        fingerprint and ``key[1]`` the dataset name (or ``"#rows"`` for
        the serving plane's row-batch decisions): the two slots the sweeps
        match on."""
        self._decisions[key] = decision

    def get_decision(self, key: tuple):
        """The steady-state lookup (None on a miss)."""
        return self._decisions.get(key)

    def drop_decisions(self, *, model_id: str | None = None,
                       dataset: str | None = None) -> int:
        """Sweep decisions by model fingerprint (``key[0]``) and / or
        dataset name (``key[1]``); both None sweeps all.  Returns entries
        dropped."""
        doomed = [k for k in self._decisions
                  if (model_id is None or k[0] == model_id)
                  and (dataset is None or k[1] == dataset)]
        for k in doomed:
            del self._decisions[k]
        return len(doomed)

    def decision_catalog(self) -> dict[tuple, dict[str, Any]]:
        """Every persisted decision, as a dict of its fields."""
        return {k: dataclasses.asdict(d) for k, d in self._decisions.items()}

    # -- model catalog --------------------------------------------------------
    def put_model(self, name: str, forest, **meta) -> dict[str, Any]:
        """Pin a forest under ``name``.  Re-pinning a name with another
        forest sweeps the replaced forest's decisions and compiled plans."""
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
            self.drop_decisions(model_id=old_fp)
            self._call_hooks(self._model_invalidators, old_fp)
        return entry

    def get_model(self, name: str):
        try:
            return self._models[name]["forest"]
        except KeyError:
            raise KeyError(f"model {name!r} not in store; "
                           f"have {sorted(self._models)}") from None

    def drop_model(self, name: str) -> bool:
        """Unpin a model; returns whether ``name`` was pinned.  Compiled
        plans keyed on its fingerprint are the caller's to sweep
        (``ForestQueryEngine.invalidate``): the store owns only the pin."""
        return self._models.pop(name, None) is not None

    def model_catalog(self) -> dict[str, dict[str, Any]]:
        return {n: {k: v for k, v in e.items() if k != "forest"}
                for n, e in self._models.items()}


class DenseStreamWriter:
    """Batch-by-batch dense ingest (``TensorBlockStore.stream_writer``).

    Rows arrive in order and are written straight into the resolved
    tier's storage, allocated up front: a tensor on the store's device, a
    (pinned) host tensor, or an EMPTY page-aligned mmap file.  ``close()``
    pads the page-alignment tail with ``fill``, flushes, registers and
    returns the ``StoredDataset``; ``abort()`` unlinks anything this writer
    created and registers nothing.
    """

    def __init__(self, store: TensorBlockStore, name: str, *,
                 num_rows: int, num_features: int, page_rows: int,
                 tier: str, task: str, dtype=torch.float32,
                 fill=float("nan"), labels: torch.Tensor | None = None):
        self.store = store
        self.name = name
        self.num_rows = int(num_rows)
        self.page_rows = int(page_rows)
        self.task = task
        self.fill = fill
        self.labels = labels
        unit = store.data_axis_size * self.page_rows
        self.total_rows = self.num_rows + (-self.num_rows) % unit
        shape = (self.total_rows, int(num_features))
        itemsize = torch.empty(0, dtype=dtype).element_size()
        self.tier = store._resolve_tier(
            tier, self.total_rows * shape[1] * itemsize)
        # a re-put's old spill files and stale decisions go away when the
        # ingest opens
        store._release_disk(name)
        store.drop_decisions(dataset=name)
        if self.tier == "disk":
            np_dtype = torch.empty(0, dtype=dtype).numpy().dtype
            self._buf = store._disk_empty(name, "rows", shape, np_dtype)
        elif self.tier == "host":
            self._buf = store._host_empty(shape, dtype)
        else:
            self._buf = torch.empty(shape, dtype=dtype, device=store.device)
        self._rows = _host_rows(self._buf)
        self._cursor = 0
        self._closed = False

    def write(self, batch) -> None:
        """Append one [rows, F] batch (numpy, or a tensor on any device)
        at the row cursor."""
        if self._closed:
            raise RuntimeError(f"stream_writer({self.name!r}) is closed")
        src = torch.as_tensor(batch)
        end = self._cursor + src.shape[0]
        if end > self.num_rows:
            raise ValueError(
                f"stream_writer({self.name!r}): batch overruns the "
                f"declared num_rows ({end} > {self.num_rows})")
        self._rows[self._cursor:end].copy_(src)
        self._cursor = end

    def abort(self) -> None:
        """Drop everything this writer created (nothing is registered)."""
        if self._closed:
            return
        self._closed = True
        self._buf = self._rows = None
        if self.tier == "disk":
            self.store._release_disk(self.name)

    def close(self) -> StoredDataset:
        """Pad, flush, register: returns the new ``StoredDataset``."""
        with TRACER.span("store.put", dataset=self.name,
                         streamed=True) as sp:
            ds = self._register()
            sp.set(tier=ds.tier)
        METRICS.counter("store.puts").inc()
        return ds

    def _register(self) -> StoredDataset:
        """``close`` without its span and count (``put``'s own)."""
        if self._closed:
            raise RuntimeError(f"stream_writer({self.name!r}) is closed")
        if self._cursor != self.num_rows:
            raise ValueError(
                f"stream_writer({self.name!r}): wrote {self._cursor} rows, "
                f"declared {self.num_rows}")
        self._closed = True
        self._rows[self._cursor:] = self.fill   # page-alignment tail
        if self.tier == "disk":
            self._buf.flush()
        ds = StoredDataset(name=self.name, data=self._buf,
                           num_rows=self.num_rows, page_rows=self.page_rows,
                           device=self.store.device, task=self.task,
                           tier=self.tier, labels=self.labels)
        self.store._datasets[self.name] = ds
        return ds
