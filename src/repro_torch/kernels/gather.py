"""Feature-gather prepass: CSR pages -> dense compact sample tiles (torch).

Mirrors ``repro/kernels/gather.py``.  Instead of densifying a wide-sparse
row to [B, F], each CSR page block is scattered straight into the forest's
COMPACT feature space [B, F_used] (``core.forest.compact_forest``), and the
forest kernels run unchanged on that tile with the remapped forest.  The
reference computes this in plain XLA (one scatter per page block), not in
a Pallas kernel, so the port's torch ops are a faithful port: a batched
``torch.searchsorted`` finds each entry's row, and one ``index_put_``
writes every entry of the block.  Its cost is O(nnz) plus writing the
tile, independent of F.

Missing-value contract: absent features become ``fill`` (NaN), so
``default_left`` routing is the dense plane's, and page padding rows come
out all-NaN like the dense store's pad rows.

Scatter targets: an entry lands at (page, row, inv_map[column]).  Capacity
padding entries (past the page's nnz) go to a phantom row R, and unused
columns and the padding sentinel (column id n_features) to a dump column
f_used; both are sliced off, so only they may collide.  Two real entries
of one row for one used column would collide with no defined winner on
CUDA: ``db/sparse.paginate_csr`` refuses such rows at ingest (a ``pages=``
handoff to ``put_sparse`` is taken as it is).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.db.sparse import CSRPages

__all__ = ["gather_inverse_map", "csr_block_to_dense", "gather_columns"]


def _index(a, device) -> torch.Tensor:
    """An index table (numpy or a tensor) as int64 on ``device``."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.int64)
    return torch.as_tensor(np.asarray(a), dtype=torch.int64, device=device)


def gather_inverse_map(gather_idx, n_features: int, *,
                       device=None) -> torch.Tensor:
    """[n_features + 1] int32: original column -> compact slot.

    Slot ``len(gather_idx)`` is the DUMP slot: unused features and the
    capacity-padding sentinel (column id n_features) land there.  The
    compact forest's padding slots repeat gather_idx[0]; the FIRST
    occurrence of a column wins, as the remapped forest reads only it."""
    idx = _index(gather_idx, "cpu")
    f_used = idx.numel()
    inv = torch.full((n_features + 1,), f_used, dtype=torch.int32)
    # each column's first slot: a stable sort keeps equal columns in slot
    # order, so every run's head is its first occurrence
    order = torch.argsort(idx, stable=True)
    col = idx[order]
    head = torch.ones_like(col, dtype=torch.bool)
    head[1:] = col[1:] != col[:-1]
    inv[col[head]] = order[head].to(torch.int32)
    return inv if device is None else inv.to(device)


def csr_block_to_dense(block: CSRPages, inv_map: torch.Tensor, f_used: int,
                       *, fill: float = float("nan")) -> torch.Tensor:
    """A CSR page block (tensors on the compute device) -> the dense
    COMPACT tile [P * page_rows, f_used] f32.

    ``inv_map`` is ``gather_inverse_map`` on the block's device; ``f_used``
    is its dump slot.  Each stored entry (row r, column c, value v) goes
    to ``out[r, inv_map[c]]``; rows keep ``fill`` where no entry lands."""
    indptr, indices, values = block.tensors()
    P, R, C = block.num_pages, block.page_rows, block.capacity
    dev = indptr.device
    entry = torch.arange(C, dtype=indptr.dtype, device=dev).expand(P, C)
    # the row of each entry: how many of the page's row ends are <= it;
    # capacity padding (past the page's nnz) falls to the phantom row R
    row = torch.searchsorted(indptr[:, 1:].contiguous(), entry.contiguous(),
                             right=True)
    col = inv_map[indices.clamp(0, inv_map.shape[0] - 1).long()].long()
    tile = torch.full((P, R + 1, f_used + 1), fill, dtype=torch.float32,
                      device=dev)
    page = torch.arange(P, device=dev)[:, None].expand(P, C)
    tile.index_put_((page, row, col), values.to(torch.float32))
    return tile[:, :R, :f_used].reshape(P * R, f_used)


def gather_columns(x: torch.Tensor, gather_idx) -> torch.Tensor:
    """Dense-plane column gather: [B, F] -> [B, F_used] with the same
    index table."""
    return torch.index_select(x, 1, _index(gather_idx, x.device))
