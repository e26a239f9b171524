"""The EXTERNAL data path: parse + convert + transfer (what netsDB avoids).

Mirrors ``repro/db/loader.py``.  Paper Sec. 4: every platform but netsDB
loads the test table from an external store (PostgreSQL through
ConnectorX, or LIBSVM files for Criteo) into the runtime's format before
inference, and the paper times that load as part of end-to-end latency: it
dominates for small models over large tables and for wide tables.

The boundary: a host-side text parse (CSV for the tabular PostgreSQL
stand-in, LIBSVM for the sparse path, array-typed rows for Epsilon), then
a dtype / layout conversion, then the host-to-device copy.  Each stage is
timed on its own with ``time.perf_counter`` (``LoadTiming``); the
transfer ends in ``torch.cuda.synchronize`` on the card.  The dense
loaders copy from pageable memory, as ``jax.device_put`` of a numpy array
does.  A loader asked for the card without one raises (``resolve_device``);
on a CPU device the device-tier load still copies, so ``transfer_s > 0``.

Values are the reference's bit for bit: text parses to float64 and then
rounds to float32, as ``np.loadtxt(dtype=float64)``, ``float(v)`` and
``np.fromstring`` do there.  Two stages are vectorised where the reference
loops in Python, with the same bytes and values: the LIBSVM parse (one
``np.fromstring`` over the whole file, lines split by counting their
``idx:val`` items) and the writers (one ``%``-format a chunk of rows).

``load_libsvm_csr_external(tier=)`` parses straight onto any rung of the
store's tier ladder: ``"host"`` returns the page arrays as CPU tensors,
pinned on a CUDA device (what the store's host tier holds), ``"disk"`` as
page-aligned ``np.memmap`` files; both with ``transfer_s == 0``, and
``store.put_sparse(pages=..., tier=...)`` registers either zero-copy.

Tracing (``repro_torch.obs``, reference ``loader.py:130-333``): every
load counts ``load.external_loads`` and runs its stages under
``load.parse`` (``format=``), ``load.convert`` (``densify=True`` for the
dense LIBSVM fallback, ``tier=`` for the CSR loader) and ``load.transfer``
spans; an off-device CSR load has no transfer and no ``load.transfer``.

Faults (``db/faults.py``, reference ``loader.py:63-72``): the three
loaders that transfer onto the device (``load_csv_external``,
``load_libsvm_external``, ``load_libsvm_csr_external`` on the device tier)
take ``injector=`` / ``retry_policy=`` and run the transfer through the
``page_dma_in`` site under the policy; with neither, the transfer is the
same direct call, and ``LoadTiming`` times what it timed.

``synth_dataset`` makes the paper's dataset grid (Tab. 1) at its shapes.
Its seed differs from the reference's on purpose: the reference adds
``hash(name)``, which Python salts per process, so its arrays change from
run to run; here the per-name offset is ``zlib.crc32`` (ROADMAP section 3).
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import time
import zlib

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.db.faults import RetryPolicy
from repro_torch.db.sparse import CSRPages, paginate_csr
from repro_torch.db.store import mmap_array
from repro_torch.obs import METRICS, TRACER

__all__ = [
    "LoadTiming",
    "DATASETS",
    "synth_dataset",
    "write_csv",
    "load_csv_external",
    "write_libsvm",
    "load_libsvm_external",
    "load_libsvm_csr_external",
    "write_array_rows",
    "load_array_rows_external",
]

#: rows formatted at once by the writers
_WRITE_CHUNK_ROWS = 4096


@dataclasses.dataclass
class LoadTiming:
    parse_s: float = 0.0       # text -> host arrays
    convert_s: float = 0.0     # layout/dtype conversion (e.g. array-col -> matrix)
    transfer_s: float = 0.0    # host -> device
    total_s: float = 0.0


# ---------------------------------------------------------------------------
# Synthetic replicas of the paper's Tab. 1 grid (scale-parameterized).
# `rows` are the full-size row counts; benchmarks pass a scale factor.
# ---------------------------------------------------------------------------

DATASETS = {
    # name: (rows, features, task, nan_fraction, kind)
    "epsilon": (100_000, 2000, "classification", 0.0, "wide-dense"),
    "fraud": (285_000, 28, "classification", 0.0, "narrow-dense"),
    "year": (515_000, 90, "regression", 0.0, "narrow-dense"),
    "bosch": (1_184_000, 968, "classification", 0.81, "wide-sparse"),
    "higgs": (11_000_000, 28, "classification", 0.0, "narrow-dense"),
    "criteo": (51_000_000, 10_000, "classification", 0.96, "sparse-libsvm"),
    "airline": (115_000_000, 13, "classification", 0.0, "narrow-dense"),
    "tpcxai": (131_000_000, 7, "classification", 0.0, "narrow-dense"),
}


def synth_dataset(name: str, *, scale: float = 1.0, seed: int = 0,
                  max_rows: int | None = None):
    """Generate (x [N, F] float32 w/ NaNs, y [N]) mirroring Tab. 1 shapes,
    the same in every process (``zlib.crc32`` of the name offsets the
    seed; the reference's salted ``hash`` does not).

    Criteo's 1M one-hot features are scale-reduced (10k) but stay extremely
    sparse -- the claim under test (sparse format shrinks transfer) is about
    density, not the absolute feature count.
    """
    rows, F, task, nan_frac, kind = DATASETS[name]
    n = int(rows * scale)
    if max_rows is not None:
        n = min(n, max_rows)
    rng = np.random.default_rng(seed + zlib.crc32(name.encode()) % 2**16)
    x = rng.normal(size=(n, F)).astype(np.float32)
    w = rng.normal(size=(min(F, 16),)).astype(np.float32)
    signal = x[:, : w.size] @ w
    if task == "regression":
        y = signal + 0.1 * rng.normal(size=n).astype(np.float32)
    else:
        y = (signal > 0).astype(np.float32)
    if nan_frac > 0:
        x[rng.random((n, F)) < nan_frac] = np.nan
    return x, y


def _write_rows(path: str, x: np.ndarray, head: str, sep: str,
                tail: str) -> None:
    """Each row of x as ``head v,v,... tail`` with every value ``%.6g``:
    the bytes of the reference's per-value formatting, one ``%`` a chunk
    of rows (a float32 formats through its exact float64 value either
    way)."""
    row = head + sep.join(["%.6g"] * x.shape[1]) + tail + "\n"
    with open(path, "w") as fh:
        for lo in range(0, x.shape[0], _WRITE_CHUNK_ROWS):
            chunk = x[lo:lo + _WRITE_CHUNK_ROWS]
            fh.write((row * chunk.shape[0])
                     % tuple(chunk.ravel().tolist()))


def _to_device(host: np.ndarray, dev: torch.device,
               dtype: torch.dtype) -> torch.Tensor:
    """The transfer stage: a copy from pageable host memory onto ``dev``
    (a copy on the CPU too), synchronised on the card."""
    out = torch.from_numpy(host).to(dev, dtype, copy=True)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return out


def _guarded_transfer(fn, *, injector=None, retry_policy=None):
    """One transfer through the ``page_dma_in`` site under a retry policy
    (``RetryPolicy()`` when only an injector is given); a direct call with
    neither."""
    if injector is None and retry_policy is None:
        return fn()
    policy = retry_policy if retry_policy is not None else RetryPolicy()
    return policy.run(fn, site="page_dma_in", injector=injector)


def _timing(t0: float, t1: float, t2: float, t3: float) -> LoadTiming:
    return LoadTiming(parse_s=t1 - t0, convert_s=t2 - t1,
                      transfer_s=t3 - t2, total_s=t3 - t0)


# ---------------------------------------------------------------------------
# CSV (tabular PostgreSQL stand-in)
# ---------------------------------------------------------------------------


def write_csv(path: str, x: np.ndarray) -> None:
    """``np.savetxt(path, x, delimiter=",", fmt="%.6g")``'s bytes."""
    _write_rows(path, x, "", ",", "")


def load_csv_external(path: str, *, device=None, dtype=torch.float32,
                      injector=None, retry_policy=None):
    """Timed external load: parse CSV -> convert -> device transfer (the
    ``page_dma_in`` site).  Returns (rows [N, F] on the device,
    LoadTiming)."""
    dev = resolve_device(device)
    METRICS.counter("load.external_loads").inc()
    t0 = time.perf_counter()
    with TRACER.span("load.parse", format="csv"):
        host = np.loadtxt(path, delimiter=",", dtype=np.float64, ndmin=2)
    t1 = time.perf_counter()
    with TRACER.span("load.convert"):
        host32 = np.ascontiguousarray(host, dtype=np.float32)
    t2 = time.perf_counter()
    with TRACER.span("load.transfer"):
        out = _guarded_transfer(lambda: _to_device(host32, dev, dtype),
                                injector=injector, retry_policy=retry_policy)
    return out, _timing(t0, t1, t2, time.perf_counter())


# ---------------------------------------------------------------------------
# LIBSVM (the sparse Criteo path)
# ---------------------------------------------------------------------------


def write_libsvm(path: str, x: np.ndarray, y: np.ndarray) -> None:
    """Rows as 'label idx:val idx:val ...' with NaN treated as missing
    (and zeros dropped), each value ``%.6g``: the reference's bytes."""
    with open(path, "w") as fh:
        for i in range(x.shape[0]):
            row = x[i]
            nz = np.flatnonzero(~np.isnan(row) & (row != 0.0))
            pairs = np.empty(2 * nz.size, dtype=object)
            pairs[0::2] = nz.tolist()
            pairs[1::2] = row[nz].tolist()
            items = " ".join(["%d:%.6g"] * nz.size) % tuple(pairs)
            fh.write(f"{y[i]:g} {items}\n")


def _parse_libsvm(path: str):
    """Text -> host CSR arrays (indptr [N+1] int64, indices int64, values
    float64, labels float64): the parse stage both LIBSVM loaders share.
    One ``np.fromstring`` parses every number of the file; a line's item
    count (its ':'s) says where its label sits."""
    with open(path, "rb") as fh:
        data = fh.read()
    lines = data.splitlines()
    counts = np.fromiter((ln.count(b":") for ln in lines), np.int64,
                         len(lines))
    flat = np.fromstring(data.replace(b":", b" ").decode(), sep=" ")
    label_at = np.cumsum(1 + 2 * counts) - (1 + 2 * counts)
    if flat.size != int((1 + 2 * counts).sum()):
        raise ValueError(f"{path}: not a LIBSVM file of 'label idx:val' "
                         f"lines")
    is_item = np.ones(flat.size, bool)
    is_item[label_at] = False
    items = flat[is_item]
    indptr = np.concatenate([[0], np.cumsum(counts)])
    return indptr, items[0::2].astype(np.int64), items[1::2], flat[label_at]


def load_libsvm_external(path: str, num_features: int, *, device=None,
                         dtype=torch.float32, missing_as_nan: bool = True,
                         injector=None, retry_policy=None):
    """Timed sparse load: parse text -> CSR -> densify -> transfer.

    The densify step is the "conversion" the paper's Criteo/Bosch pipelines
    pay (sparse store format -> the dense blocks inference kernels want).
    This is the DENSE-FALLBACK baseline; ``load_libsvm_csr_external`` is
    the sparse data plane's path, which skips the densify entirely.  The
    transfer is the ``page_dma_in`` site.
    Returns (rows [N, F] on the device, labels [N] np f32, LoadTiming).
    """
    dev = resolve_device(device)
    METRICS.counter("load.external_loads").inc()
    t0 = time.perf_counter()
    with TRACER.span("load.parse", format="libsvm"):
        indptr, indices, values, labels = _parse_libsvm(path)
        values = values.astype(np.float32)
    t1 = time.perf_counter()
    with TRACER.span("load.convert", densify=True):
        n = labels.size
        dense = np.full((n, num_features),
                        np.nan if missing_as_nan else 0.0, np.float32)
        rows = np.repeat(np.arange(n), np.diff(indptr))
        dense[rows, indices] = values
    t2 = time.perf_counter()
    with TRACER.span("load.transfer"):
        out = _guarded_transfer(lambda: _to_device(dense, dev, dtype),
                                injector=injector, retry_policy=retry_policy)
    return (out, labels.astype(np.float32),
            _timing(t0, t1, t2, time.perf_counter()))


def load_libsvm_csr_external(path: str, num_features: int, *,
                             page_rows: int = 512, pages_multiple: int = 1,
                             tier: str = "device",
                             spill_dir: str | None = None, device=None,
                             injector=None, retry_policy=None):
    """Timed sparse load, SPARSE data plane: parse -> CSR pages -> transfer.

    Never builds [N, F] on the host: the parse gives host CSR arrays, the
    convert stage lays them out as fixed-capacity CSR page blocks
    (``db/sparse.paginate_csr``, the layout the store holds), and the
    transfer ships indptr / indices / values only.

    ``tier="host"``: no transfer (``transfer_s == 0``); the page arrays
    come back as CPU tensors, pinned on a CUDA ``device`` (the pin is part
    of the convert stage), ready for ``store.put_sparse(pages=...,
    tier="host")`` to register as they are.  ``tier="disk"``: the three
    page arrays are written to page-aligned memory-mapped files
    ``<stem>.{indptr,indices,values}.bin`` (``store.mmap_array``) in
    ``spill_dir`` or a fresh temporary directory, and come back as
    ``np.memmap`` views, also with ``transfer_s == 0``; the files belong
    to the caller (a store that registers them never deletes them).  The
    device tier's transfer is the ``page_dma_in`` site.

    Returns (CSRPages on ``tier``, labels [N] np f32, LoadTiming).
    """
    if tier not in ("device", "host", "disk"):
        raise ValueError(f"unknown tier {tier!r}")
    dev = resolve_device(device)
    METRICS.counter("load.external_loads").inc()
    t0 = time.perf_counter()
    with TRACER.span("load.parse", format="libsvm-csr"):
        indptr, indices, values, labels = _parse_libsvm(path)
    t1 = time.perf_counter()
    with TRACER.span("load.convert", tier=tier):
        arrays = paginate_csr(indptr, indices.astype(np.int32),
                              values.astype(np.float32),
                              num_rows=labels.size, page_rows=page_rows,
                              n_features=num_features,
                              pages_multiple=pages_multiple)
        if tier == "host" and dev.type == "cuda":
            arrays = tuple(a.pin_memory() for a in arrays)
        elif tier == "disk":
            d = spill_dir or tempfile.mkdtemp(prefix="libsvm-disk-")
            stem = os.path.splitext(os.path.basename(path))[0]
            arrays = tuple(
                mmap_array(os.path.join(d, f"{stem}.{label}.bin"), a)
                for label, a in zip(("indptr", "indices", "values"),
                                    arrays))
    t2 = time.perf_counter()
    if tier == "device":
        def transfer():
            out = tuple(a.to(dev, copy=True) for a in arrays)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            return out

        with TRACER.span("load.transfer"):
            arrays = _guarded_transfer(transfer, injector=injector,
                                       retry_policy=retry_policy)
        t3 = time.perf_counter()
    else:
        t3 = t2                 # no device transfer: transfer_s == 0
    pages = CSRPages(*arrays, n_features=int(num_features), tier=tier)
    return (pages, labels.astype(np.float32),
            _timing(t0, t1, t2, t3))


# ---------------------------------------------------------------------------
# Array-typed rows (the Epsilon path: PostgreSQL array columns)
# ---------------------------------------------------------------------------


def write_array_rows(path: str, x: np.ndarray) -> None:
    """Each row as a '{v1,v2,...}' array literal -- the PostgreSQL array-type
    storage the paper is forced into for >1600-column tables (Sec. 6.3.2)."""
    _write_rows(path, x, "{", ",", "}")


def load_array_rows_external(path: str, *, device=None, dtype=torch.float32):
    """Timed array-column load; the expensive step is the per-row array
    parse + stack (the paper's 'converting a PostgreSQL array type back to
    a NumPy array ... becomes the bottleneck').  Returns (rows [N, F] on
    the device, LoadTiming)."""
    dev = resolve_device(device)
    METRICS.counter("load.external_loads").inc()
    t0 = time.perf_counter()
    with TRACER.span("load.parse", format="array-rows"):
        rows = []
        with open(path) as fh:
            for line in fh:
                rows.append(np.fromstring(line.strip()[1:-1], sep=","))
    t1 = time.perf_counter()
    with TRACER.span("load.convert"):
        host = np.stack(rows).astype(np.float32)
    t2 = time.perf_counter()
    with TRACER.span("load.transfer"):
        out = _to_device(host, dev, dtype)
    return out, _timing(t0, t1, t2, time.perf_counter())
