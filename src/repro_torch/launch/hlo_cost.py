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
                   the last tensor over it goes;
  collective_*     what the port's own code records with
                   ``dist/collectives.record_collective`` (this mode is its
                   recorder while it counts) at the points where a mesh would
                   exchange data (the EP ``all_to_all`` and its exchange
                   back, the EP decode's ``psum``, the cross-pod all-reduce
                   of the int8 levels and scales), with the reference's
                   two conventions per kind (``roofline.CollectiveStats``).
                   The tensor- and data-parallel collectives that XLA's
                   partitioner inserts have no counterpart in the port.

Every figure is the whole call's: the positions of a mesh all run on one
device, so the dry-run divides by the positions for a per-position figure
(``launch/dryrun.py``).  On ``device="meta"`` tensors nothing is allocated
and nothing computed, which makes a full-width step countable in seconds;
the count never reads a tensor's value, and the mode changes no result.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Any, Callable

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.dist.collectives import set_recorder
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
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class CostMode(TorchDispatchMode):
    """Counts every aten op dispatched while it is active (see the module
    docstring); ``summary()`` gives ``analyze``'s record.  ``held`` are
    trees of tensors live for the whole call (the arguments): their
    storages count towards ``peak_live_bytes`` from the start."""

    def __init__(self, held: Any = ()) -> None:
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.ops = 0
        self.by_op: dict[str, list] = defaultdict(lambda: [0, 0, 0.0])
        self.ops_by_device: dict[str, set[str]] = defaultdict(set)
        self.collectives = CollectiveStats({}, {}, {})
        self._held: set[int] = set()
        self._live: dict[int, tuple[StorageWeakRef, int]] = {}
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
        return super().__exit__(*exc)

    # -- the live storages ----------------------------------------------------
    def _sweep(self) -> None:
        gone = [k for k, (ref, _) in self._live.items() if ref.expired()]
        for k in gone:
            self._live_bytes -= self._live.pop(k)[1]

    def _made(self, outs: list[torch.Tensor]) -> None:
        for t in outs:
            s = t.untyped_storage()
            k = s._cdata
            if k in self._held:
                continue
            entry = self._live.get(k)
            if entry is not None:
                if not entry[0].expired():
                    continue                  # a storage already counted
                self._live_bytes -= entry[1]  # a freed storage's address
            self._live[k] = (StorageWeakRef(s), s.nbytes())
            self._live_bytes += s.nbytes()
        # storages freed since the last sweep only raise the total: sweep
        # them out before the total may set a new peak
        if self._held_bytes + self._live_bytes > self.peak_live_bytes:
            self._sweep()
            self.peak_live_bytes = max(self.peak_live_bytes,
                                       self._held_bytes + self._live_bytes)

    # -- the dispatch ---------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
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

    def collective(self, kind: str, nbytes: int, group: int,
                   members: int) -> None:
        """One collective over ``members`` positions in groups of
        ``group``, each member's result buffer ``nbytes``: the reference's
        operand and ring-wire conventions (``hlo_cost.analyze``), summed
        over the members."""
        r, g = int(nbytes), max(int(group), 1)
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
