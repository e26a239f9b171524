"""The collective record: where the port's own code would exchange data.

The port runs every position of a mesh on one device, so no collective
runs; the points where a mesh would run one (the EP ``all_to_all`` and
its exchange back, the EP decode's ``psum``, the cross-pod all-reduce of
the int8 levels and scales) call ``record_collective`` or ``exchange``
here.  Both do nothing unless a recorder is set: ``launch/hlo_cost``'s
``CostMode`` sets itself while it counts and clears itself after.  The
slot is one per process, not per thread, so autograd's device thread
records the backward's exchanges too.
"""

from __future__ import annotations

from typing import Any

import torch

__all__ = ["set_recorder", "recording", "record_collective", "exchange"]

#: the active recorder: an object with ``collective(kind, nbytes, group,
#: members)``, or None
_recorder: Any = None


def set_recorder(recorder: Any) -> Any:
    """Make ``recorder`` the active one (None: none) and return the one it
    replaces, for the caller to restore."""
    global _recorder
    prev, _recorder = _recorder, recorder
    return prev


def recording() -> bool:
    """Whether a recorder is set."""
    return _recorder is not None


def record_collective(kind: str, nbytes: int, *, group: int,
                      members: int) -> None:
    """Record one collective a mesh of positions would run here: ``kind``
    in the HLO's names (``"all-to-all"``, ``"all-reduce"``, ...),
    ``nbytes`` each member's result buffer, ``group`` the members of one
    group, ``members`` every position taking part.  A no-op unless a
    recorder is set."""
    rec = _recorder
    if rec is not None:
        rec.collective(kind, nbytes, group, members)


class _Exchange(torch.autograd.Function):
    """Identity that records its collective in forward and again in
    backward, where autograd runs back through it."""

    @staticmethod
    def forward(ctx, x, kind, group, members):
        ctx.collective = (kind, x.numel() * x.element_size() // members,
                          group, members)
        record_collective(kind, ctx.collective[1], group=group,
                          members=members)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        kind, nbytes, group, members = ctx.collective
        record_collective(kind, nbytes, group=group, members=members)
        return grad, None, None, None


def exchange(x: torch.Tensor, kind: str, *, group: int,
             members: int) -> torch.Tensor:
    """``x``: the buffers of one collective over all ``members`` positions
    (each member's share ``x``'s bytes / ``members``).  While a recorder is
    set, the collective is recorded here, and again in backward where
    autograd runs back through it (the transpose of an all-to-all is an
    all-to-all of the same size).  Otherwise ``x`` itself, untouched."""
    if not recording():
        return x
    return _Exchange.apply(x, kind, group, members)
