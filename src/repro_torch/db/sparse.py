"""CSR tensor-block pages: the sparse data plane's storage format (torch).

Mirrors ``repro/db/sparse.py``.  The paper's wide-sparse workloads (Bosch,
968 features at 81 % missing; Criteo LIBSVM at 96 %) are where densifying
on ingest multiplies the store's bytes and the host-to-device transfer by
1 / density.  The store keeps such tables as CSR pages on every tier, and
the feature-gather prepass (``kernels/gather.py``) expands each page block
straight into the forest's COMPACT feature space, never into F.

Layout: a sparse dataset is THREE page arrays with a fixed per-page entry
capacity

    indptr   [P, R+1] int32   row offsets WITHIN the page (indptr[p,0]==0)
    indices  [P, C]   int32   column ids; padding entries hold n_features
    values   [P, C]   f32     stored values (explicit zeros are kept)

where R = ``page_rows`` and C = the largest page's entry count rounded up
to ``LANE``.  Every page block has the same shape, so the dense store's
page <-> batch determinism and the plan cache's one-signature-per-batching
rule carry over.  Missing features are not stored: the gather prepass
makes them NaN again, so ``default_left`` routing is the dense plane's.

The arrays are tensors on the store's device (device tier), CPU tensors,
pinned on a CUDA store (host tier), or ``np.memmap`` spill files (disk
tier); ``CSRPages.tier`` says which.  The construction functions are
vectorised torch and run on any device: the reference's per-page Python
loop is too slow for a table of millions of rows.  They produce the
reference's arrays exactly.  Unlike the reference, ``paginate_csr`` refuses
a row that holds two entries for one column: the gather's scatter would
give them no defined winner.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

__all__ = ["CSRPages", "csr_from_dense", "paginate_csr", "pad_pages",
           "csr_pages_from_dense", "concat_pages", "densify_csr", "LANE"]

#: capacity granularity (the reference's f32 lane)
LANE = 128


def _tensor(a) -> torch.Tensor:
    """A page array as a tensor: a memmap as a tensor over the mapping (no
    copy), a tensor as itself."""
    return torch.from_numpy(a) if isinstance(a, np.ndarray) else a


@dataclasses.dataclass(frozen=True)
class CSRPages:
    """A CSR page block (a whole dataset or a batch slice) on one tier."""

    indptr: Any                   # [P, R+1] int32, page-local offsets
    indices: Any                  # [P, C] int32, pad entries = n_features
    values: Any                   # [P, C] f32
    n_features: int = 0
    tier: str = "device"          # "device" | "host" | "disk"

    @property
    def num_pages(self) -> int:
        return self.indptr.shape[0]

    @property
    def page_rows(self) -> int:
        return self.indptr.shape[1] - 1

    @property
    def capacity(self) -> int:
        return self.indices.shape[1]

    @property
    def num_rows_padded(self) -> int:
        return self.num_pages * self.page_rows

    @property
    def nbytes(self) -> int:
        return sum(int(a.nbytes) for a in self.arrays())

    def arrays(self) -> tuple:
        """(indptr, indices, values), in the block's own tier."""
        return self.indptr, self.indices, self.values

    def tensors(self) -> tuple[torch.Tensor, ...]:
        """The three arrays as tensors (a disk tier's over its mapping)."""
        return tuple(_tensor(a) for a in self.arrays())

    def replace(self, arrays, tier: str | None = None) -> "CSRPages":
        """The same block description over other (indptr, indices,
        values)."""
        ip, ix, vl = arrays
        return dataclasses.replace(self, indptr=ip, indices=ix, values=vl,
                                   tier=self.tier if tier is None else tier)

    def page_slice(self, first_page: int, num_pages: int) -> "CSRPages":
        """A contiguous page range, a view in the block's own tier (a disk
        tier's slice is three lazy memmap views): page p of batch k is
        always the same rows and the same block shape."""
        end = first_page + num_pages
        return self.replace(tuple(a[first_page:end] for a in self.arrays()))


def csr_from_dense(x, *, drop_zeros: bool = False
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """[N, F] dense rows with NaN = missing (numpy, or a tensor on any
    device) -> CSR (indptr [N+1] int64, indices int32, values f32) on x's
    device.  Explicit zeros are kept unless ``drop_zeros``."""
    x = torch.as_tensor(x)
    present = ~torch.isnan(x)
    if drop_zeros:
        present &= x != 0.0
    indptr = torch.zeros(x.shape[0] + 1, dtype=torch.int64, device=x.device)
    torch.cumsum(present.sum(dim=1), dim=0, out=indptr[1:])
    rows, cols = present.nonzero(as_tuple=True)
    return indptr, cols.to(torch.int32), x[rows, cols].to(torch.float32)


def _refuse_duplicates(indptr: torch.Tensor, indices: torch.Tensor,
                       n_features: int) -> None:
    """Raise on a column id outside [0, n_features) or on a row holding two
    entries for one column.  One pass when each row's ids increase, as
    ``csr_from_dense`` and LIBSVM files give them."""
    lo, hi = int(indptr[0]), int(indptr[-1])
    ids = indices[lo:hi].long()
    if ids.numel() == 0:
        return
    if int(ids.min()) < 0 or int(ids.max()) >= n_features:
        raise ValueError(f"CSR column ids must lie in [0, {n_features})")
    counts = (indptr[1:] - indptr[:-1]).long()
    row = torch.repeat_interleave(
        torch.arange(counts.numel(), device=ids.device), counts)
    same_row = row[1:] == row[:-1]
    if not bool((same_row & (ids[1:] <= ids[:-1])).any()):
        return
    keys = row * n_features + ids
    if torch.unique(keys).numel() != keys.numel():
        raise ValueError("a CSR row holds two entries for one column; the "
                         "gather prepass would give them no defined winner")


def paginate_csr(indptr, indices, values, *, num_rows: int, page_rows: int,
                 n_features: int, pages_multiple: int = 1,
                 lane: int = LANE
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """CSR (indptr [N+1], indices, values; numpy or tensors) -> fixed-
    capacity page arrays on the inputs' device, the reference's exactly.

    Rows pad to whole pages as EMPTY rows (every feature missing: the
    dense store's NaN rows), the page count to ``pages_multiple``.
    Capacity C = the largest page's entry count rounded up to ``lane`` (at
    least ``lane``); padding entries hold column id ``n_features``, which
    the gather prepass routes to a dump slot."""
    indptr = torch.as_tensor(indptr).to(torch.int64)
    indices = torch.as_tensor(indices, device=indptr.device)
    values = torch.as_tensor(values, device=indptr.device)
    if indptr.shape[0] != num_rows + 1:
        raise ValueError(f"indptr has {indptr.shape[0]} entries for "
                         f"{num_rows} rows")
    _refuse_duplicates(indptr, indices, n_features)
    dev = indptr.device
    num_pages = -(-num_rows // page_rows)
    num_pages += (-num_pages) % pages_multiple
    num_pages = max(num_pages, pages_multiple)
    padded_rows = num_pages * page_rows
    full = torch.cat([indptr, indptr[-1:].expand(padded_rows - num_rows)])
    starts = full[::page_rows]                             # [P+1]
    page_nnz = starts[1:] - starts[:-1]
    cap = int(page_nnz.max()) if num_pages else 0
    cap = max(lane, -(-cap // lane) * lane)

    at = (torch.arange(num_pages, device=dev)[:, None] * page_rows
          + torch.arange(page_rows + 1, device=dev)[None])
    out_indptr = (full[at] - starts[:-1, None]).to(torch.int32)
    out_indices = torch.full((num_pages, cap), n_features, dtype=torch.int32,
                             device=dev)
    out_values = torch.zeros((num_pages, cap), dtype=torch.float32,
                             device=dev)
    lo, hi = int(starts[0]), int(starts[-1])
    # entry e of page p lands at slot e - starts[p] of row p
    page = torch.repeat_interleave(torch.arange(num_pages, device=dev),
                                   page_nnz)
    slot = (torch.arange(lo, hi, device=dev) - starts[:-1][page]
            + page * cap)
    out_indices.view(-1)[slot] = indices[lo:hi].to(torch.int32)
    out_values.view(-1)[slot] = values[lo:hi].to(torch.float32)
    return out_indptr, out_indices, out_values


def pad_pages(pages: CSRPages, pages_multiple: int) -> CSRPages:
    """``pages`` with EMPTY pages appended up to a multiple of
    ``pages_multiple`` (a mesh store's data axis); ``pages`` itself when
    the count divides already.  The padded arrays are tensors on the
    pages' device (a disk tier's maps are read)."""
    pad = (-pages.num_pages) % pages_multiple
    if pad == 0:
        return pages
    ip, ix, vl = pages.tensors()
    fills = ((ip, 0), (ix, pages.n_features), (vl, 0.0))
    return pages.replace(tuple(
        torch.cat([a, a.new_full((pad,) + tuple(a.shape[1:]), fill)])
        for a, fill in fills))


def csr_pages_from_dense(x, *, page_rows: int, pages_multiple: int = 1,
                         lane: int = LANE,
                         drop_zeros: bool = False) -> CSRPages:
    """Dense rows with NaN = missing -> device-tier ``CSRPages`` on x's
    device."""
    x = torch.as_tensor(x)
    n, f = x.shape
    ip, ix, vl = paginate_csr(*csr_from_dense(x, drop_zeros=drop_zeros),
                              num_rows=n, page_rows=page_rows, n_features=f,
                              pages_multiple=pages_multiple, lane=lane)
    return CSRPages(indptr=ip, indices=ix, values=vl, n_features=f)


def concat_pages(blocks, *, n_features: int) -> CSRPages:
    """Page arrays ``(indptr, indices, values)`` paginated chunk by chunk,
    in row order, each chunk whole pages but the last -> one device-tier
    ``CSRPages``, every chunk's capacity padded to the largest: exactly
    what ``paginate_csr`` gives for the whole table, built without ever
    holding it unpaginated."""
    cap = max(ix.shape[1] for _, ix, _ in blocks)

    def widen(a: torch.Tensor, fill) -> torch.Tensor:
        if a.shape[1] == cap:
            return a
        pad = torch.full((a.shape[0], cap - a.shape[1]), fill,
                         dtype=a.dtype, device=a.device)
        return torch.cat([a, pad], dim=1)

    return CSRPages(
        indptr=torch.cat([ip for ip, _, _ in blocks]),
        indices=torch.cat([widen(ix, n_features) for _, ix, _ in blocks]),
        values=torch.cat([widen(vl, 0.0) for _, _, vl in blocks]),
        n_features=n_features)


def densify_csr(indptr, indices, values, n_features: int, *,
                fill: float = float("nan")) -> torch.Tensor:
    """Page arrays -> dense [P * R, n_features] f32 on their device (tests,
    parity and the card's dense cross-check only: the query path never
    builds [N, F])."""
    indptr, indices, values = (_tensor(a) if isinstance(a, np.ndarray)
                               else torch.as_tensor(a)
                               for a in (indptr, indices, values))
    P, R = indptr.shape[0], indptr.shape[1] - 1
    C = indices.shape[1]
    dev = indptr.device
    out = torch.full((P * R, n_features), fill, dtype=torch.float32,
                     device=dev)
    entry = torch.arange(C, dtype=indptr.dtype, device=dev).expand(P, C)
    row = torch.searchsorted(indptr[:, 1:].contiguous(), entry.contiguous(),
                             right=True)
    real = row < R
    flat_row = (torch.arange(P, device=dev)[:, None] * R + row)[real]
    out[flat_row, indices[real].long()] = values[real].to(torch.float32)
    return out
