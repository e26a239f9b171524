"""Op-level cost counter: the port's counterpart of the HLO cost pass.

Mirrors ``repro/launch/hlo_cost.py`` in what it returns, not in what it
reads.  The reference compiles a step with XLA and re-derives its per-chip
costs from the compiled HLO text, trip counts included.  Eager PyTorch has
no compiled whole-step program: it runs one aten op at a time, each one
kernel (or none, for a view).  So ``analyze(fn, *args, **kw)`` runs ``fn``
once under a ``TorchDispatchMode`` and counts every aten op it dispatches,
the backward's too when ``fn`` calls it (autograd hands the mode to its
device thread):

  flops            products only, 2 * |result| * K, from the formulas
                   ``torch.utils.flop_counter`` registers (mm, bmm, addmm,
                   baddbmm, convolution, scaled-dot-product attention):
                   the counterpart of ``hlo_cost._dot_flops``, elementwise
                   work ignored as there;
  bytes            operands + results of every op that moves data; views
                   and metadata ops count none (the counterpart of
                   ``_SKIP_BYTES_OPS``), and a gather (``index``,
                   ``index_select``, ``embedding``, ``gather``) reads of
                   its source no more than it gathers: its indices, the
                   smaller of source and result, and its result written.
                   Eager bytes: nothing is fused, so this is the port's
                   own traffic, not XLA's;
  ops              aten ops dispatched, views included;
  peak_live_bytes  the peak of the bytes held live during the call: the
                   arguments' storages and every storage an op made,
                   each storage once (views share one), released when
                   the last tensor over it goes (one held in a reference
                   cycle when Python's cyclic collector frees it, whose
                   timing can move the peak by that storage);
  collective_*     what the port's own code records with
                   ``dist/collectives.record_collective`` (this mode is its
                   recorder while it counts), with the reference's two
                   conventions per kind (``roofline.CollectiveStats``).  A
                   held-once step records only the points where a mesh
                   would exchange data (the EP ``all_to_all`` and its
                   exchange back, the EP decode's ``psum``, the cross-pod
                   all-reduce of the int8 levels and scales); a step over
                   positions that own their shards records every move
                   between them, the counterpart of the collectives XLA's
                   partitioner inserts.

Every figure is the whole call's: the positions of a mesh all run on one
device, so the dry-run divides by the positions for a per-position figure
(``launch/dryrun.py``).  On ``device="meta"`` tensors nothing is allocated
and nothing computed, which makes a full-width step countable in seconds;
the count never reads a tensor's value, and the mode changes no result.
On meta the mode keeps each op's result by signature (the op, its
arguments' shapes, strides, dtypes and values; ``memo``): an op that
neither views nor mutates is then run once a signature, and its later
calls, every other position's on a mesh, get fresh meta tensors of the
same shape, each counted as the op it is.
"""

from __future__ import annotations

import functools
import weakref
from collections import defaultdict
from typing import Any, Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.dist.collectives import set_recorder
from repro_torch.dist.sharding import Sharded
from repro_torch.launch.roofline import CollectiveStats

__all__ = ["CostMode", "analyze"]

aten = torch.ops.aten

#: ops that move no data beyond what a view does: they count in ``ops``,
#: not in ``bytes`` (the counterpart of the reference's _SKIP_BYTES_OPS)
_NO_BYTES = {aten.empty, aten.empty_strided, aten.empty_like,
             aten.new_empty, aten.new_empty_strided, aten._unsafe_view,
             aten.sym_size, aten.sym_stride, aten.sym_numel,
             aten.sym_storage_offset, aten.is_same_size, aten.set_}

#: gathers: the source (the first argument) is read only where indexed
_GATHERS = {aten.index, aten.index_select, aten.embedding, aten.gather}


def _tensors(tree) -> list[torch.Tensor]:
    """The tensors of ``tree`` (nested lists, tuples and dicts, as an aten
    op's arguments and results are), in order, a ``Sharded`` leaf's
    pieces each.  A walk of its own: ``torch.utils._pytree`` costs a
    sixth of a production-mesh count, run twice an op."""
    out: list[torch.Tensor] = []
    _walk(tree, out)
    return out


def _walk(x, out: list) -> None:
    # a module function, not a closure: a closure that calls itself is a
    # reference cycle, which would keep an op's result alive past the
    # dispatch, and torch then hands a factory op's result back detached
    # (one more op counted)
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for y in x:
            _walk(y, out)
    elif isinstance(x, dict):
        for y in x.values():
            _walk(y, out)
    elif isinstance(x, Sharded):
        out.extend(x.pieces.values())


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _NotMeta(Exception):
    """An argument that keeps an op's meta result from being kept."""


_MEMOABLE: dict = {}


def _memoable(func) -> bool:
    """Whether ``func``'s result is a function of its arguments' metadata
    alone: no view, no mutation, no result aliasing an argument."""
    ok = _MEMOABLE.get(func)
    if ok is None:
        schema = func._schema
        ok = not (func.is_view or schema.is_mutable or any(
            r.alias_info is not None for r in schema.returns))
        _MEMOABLE[func] = ok
    return ok


def _sig(x):
    """A hashable signature of an op's argument; raises ``_NotMeta`` for a
    tensor off meta or a value that cannot be hashed."""
    if isinstance(x, torch.Tensor):
        if x.device.type != "meta":
            raise _NotMeta
        return (x.shape, x.stride(), x.dtype, x.storage_offset())
    if isinstance(x, (list, tuple)):
        return (type(x), tuple(_sig(y) for y in x))
    if isinstance(x, dict):
        return tuple((k, _sig(v)) for k, v in x.items())
    try:
        hash(x)
    except TypeError:
        raise _NotMeta from None
    return x


def _shell(out, args, kwargs):
    """What ``_remake`` needs to make ``out`` again: each result's shape,
    stride, dtype and storage bytes; False where it cannot (a result that
    is not fresh meta tensors, or one sharing an argument's storage)."""
    outs = [out] if isinstance(out, torch.Tensor) else out
    if not isinstance(outs, (list, tuple)) or not outs or not all(
            isinstance(t, torch.Tensor) and t.device.type == "meta"
            and t.storage_offset() == 0 for t in outs):
        return False
    seen = {t.untyped_storage()._cdata for t in _tensors((args, kwargs))}
    shells = []
    for t in outs:
        s = t.untyped_storage()
        if s._cdata in seen:
            return False
        seen.add(s._cdata)
        shells.append((tuple(t.shape), t.stride(), t.dtype, s.nbytes()))
    return (isinstance(out, torch.Tensor), type(out), shells)


def _remake(shell):
    """Fresh meta tensors as ``_shell`` described them (None where one
    would hold other storage bytes than the op's own result did)."""
    single, kind, shells = shell
    outs = []
    for shape, stride, dtype, nbytes in shells:
        t = torch.empty_strided(shape, stride, dtype=dtype, device="meta")
        if t.untyped_storage().nbytes() != nbytes:
            return None
        outs.append(t)
    return outs[0] if single else kind(outs)


class CostMode(TorchDispatchMode):
    """Counts every aten op dispatched while it is active (see the module
    docstring); ``summary()`` gives ``analyze``'s record.  ``held`` are
    trees of tensors live for the whole call (the arguments, a
    ``Sharded``'s pieces included): their storages count towards
    ``peak_live_bytes`` from the start.  ``memo=False`` runs every meta
    kernel (``_memo_key``), the count the kept results must equal."""

    def __init__(self, held: Any = (), *, memo: bool = True) -> None:
        super().__init__()
        self._memo: dict | None = {} if memo else None
        self.flops = 0.0
        self.bytes = 0.0
        self.ops = 0
        self.by_op: dict[str, list] = defaultdict(lambda: [0, 0, 0.0])
        self.ops_by_device: dict[str, set[str]] = defaultdict(set)
        self.collectives = CollectiveStats({}, {}, {})
        self.records: list[tuple] = []
        self._held: set[int] = set()
        self._live: dict[int, tuple[weakref.ref, int]] = {}
        self._held_bytes = 0
        self._live_bytes = 0
        for t in _tensors(held):
            s = t.untyped_storage()
            if s._cdata not in self._held:
                self._held.add(s._cdata)
                self._held_bytes += s.nbytes()
        self.peak_live_bytes = self._held_bytes

    def __enter__(self):
        self._prev_recorder = set_recorder(self)
        return super().__enter__()

    def __exit__(self, *exc):
        set_recorder(self._prev_recorder)
        self._live.clear()                    # no callbacks after the count
        return super().__exit__(*exc)

    # -- the live storages ----------------------------------------------------
    def _freed(self, key: int, ref: weakref.ref) -> None:
        """A counted storage went (its weak reference's callback)."""
        entry = self._live.get(key)
        if entry is not None and entry[0] is ref:
            del self._live[key]
            self._live_bytes -= entry[1]

    def _made(self, outs: list[torch.Tensor]) -> None:
        # a storage's Python object lives as long as the storage does (torch
        # preserves it), so a weak reference to it says when the storage
        # goes, and the live total is exact after every op without a sweep
        # of every live storage (which made a long count quadratic)
        for t in outs:
            s = t.untyped_storage()
            k = s._cdata
            if k in self._held or k in self._live:
                continue                      # a storage already counted
            n = s.nbytes()
            self._live[k] = (weakref.ref(s, functools.partial(self._freed,
                                                              k)), n)
            self._live_bytes += n
        total = self._held_bytes + self._live_bytes
        if total > self.peak_live_bytes:
            self.peak_live_bytes = total

    # -- the dispatch ---------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        key = self._memo_key(func, args, kwargs)
        shell = None if key is None else self._memo.get(key)
        out = _remake(shell) if shell else None
        if out is None:
            out = func(*args, **kwargs)
            if key is not None and shell is None:
                self._memo[key] = _shell(out, args, kwargs)
        packet = func._overloadpacket
        name = str(packet).removeprefix("aten.")
        rec = self.by_op[name]
        rec[0] += 1
        self.ops += 1
        if packet in flop_registry:
            f = float(flop_registry[packet](*args, **kwargs, out_val=out))
            self.flops += f
            rec[2] += f
        outs = _tensors(out)
        for t in outs:
            self.ops_by_device[str(t.device)].add(name)
        if not (func.is_view or packet in _NO_BYTES):
            if packet in _GATHERS:
                src = args[0]
                rest = [t for t in _tensors((args, kwargs)) if t is not src]
                out_b = sum(_nbytes(t) for t in outs)
                b = sum(_nbytes(t) for t in rest) + \
                    min(_nbytes(src), out_b) + out_b
            else:
                b = sum(_nbytes(t) for t in _tensors((args, kwargs))) + \
                    sum(_nbytes(t) for t in outs)
            self.bytes += b
            rec[1] += b
        if outs:
            self._made(outs)
        return out

    # -- meta results kept by signature -----------------------------------------
    def _memo_key(self, func, args, kwargs):
        """The key under which a meta op's result is kept: the op and its
        arguments' shapes, strides, dtypes and values, when every tensor
        is on meta and the op neither views nor mutates (None
        otherwise).  A position's op on meta is the same op at every
        other position of the mesh, so a production-mesh count runs
        each meta kernel (shape inference, in Python for most ops) once a
        signature and not once a position."""
        if self._memo is None or not _memoable(func):
            return None
        try:
            return (func, _sig(args), _sig(kwargs))
        except _NotMeta:
            return None

    def collective(self, kind: str, nbytes: int, group: int,
                   members: int) -> None:
        """One collective over ``members`` positions in groups of
        ``group``, each member's result buffer ``nbytes``: the reference's
        operand and ring-wire conventions (``hlo_cost.analyze``), summed
        over the members; the record itself kept in ``records``, in call
        order."""
        r, g = int(nbytes), max(int(group), 1)
        self.records.append((kind, r, int(group), int(members)))
        if kind == "all-gather":
            op_b, wire = r // g, r * (g - 1) // g
        elif kind == "all-reduce":
            op_b, wire = r, 2 * r * (g - 1) // g
        elif kind == "reduce-scatter":
            op_b, wire = r * g, r * (g - 1)
        elif kind == "all-to-all":
            op_b, wire = r, r * (g - 1) // g
        elif kind == "collective-permute":
            op_b, wire = r, r
        else:
            raise ValueError(f"unknown collective kind {kind!r}")
        c = self.collectives
        c.counts[kind] = c.counts.get(kind, 0) + members
        c.bytes_by_kind[kind] = c.bytes_by_kind.get(kind, 0) + members * op_b
        c.wire_bytes_by_kind[kind] = (c.wire_bytes_by_kind.get(kind, 0)
                                      + members * wire)

    def summary(self) -> dict:
        c = self.collectives
        return {
            "flops": self.flops,
            "bytes": self.bytes,
            "collective_bytes": float(c.total_bytes),
            "collective_wire_bytes": float(c.total_wire_bytes),
            "collective_counts": dict(c.counts),
            "collective_bytes_by_kind": dict(c.bytes_by_kind),
            "collective_wire_bytes_by_kind": dict(c.wire_bytes_by_kind),
            "ops": self.ops,
            "peak_live_bytes": self.peak_live_bytes,
            "devices": sorted(self.ops_by_device),
            "ops_by_device": {d: sorted(ops) for d, ops in
                              sorted(self.ops_by_device.items())},
            "by_op": {k: {"count": v[0], "bytes": v[1], "flops": v[2]}
                      for k, v in sorted(self.by_op.items())},
        }


def analyze(fn: Callable, *args, **kw) -> dict:
    """Run ``fn(*args, **kw)`` once under a ``CostMode`` and return its
    record: the reference's keys (``flops``, ``bytes``,
    ``collective_bytes``, ``collective_wire_bytes``, ``collective_counts``,
    ``collective_bytes_by_kind``) plus ``ops``, ``peak_live_bytes``,
    ``devices`` (where the ops' results lie), ``ops_by_device`` (the ops
    with results on each) and ``by_op`` (count, bytes and flops of each
    aten op).  ``fn``'s result
    is dropped before the call returns."""
    with CostMode(held=(args, kw)) as mode:
        fn(*args, **kw)
    return mode.summary()
