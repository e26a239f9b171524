"""Collectives: the moves between positions, and their record.

Two kinds of caller use this module.

A plan held once (every position on one device, one copy of each value)
runs no collective: the points where a mesh would run one (the EP
``all_to_all`` and its exchange back, the EP decode's ``psum``, the
cross-pod all-reduce of the int8 levels and scales) call
``record_collective`` or ``exchange`` here, which record it and move
nothing.

A plan whose positions own their shards (``dist/sharding.Sharded``) moves
every byte that crosses positions through the functions below, over the
pieces of a ``Sharded`` along named mesh axes: ``all_gather``,
``reduce_scatter``, ``psum``, ``all_to_all``, ``broadcast`` and
``relayout`` (a value moved from one spec to another by those moves and
local slices).  Each copies the pieces it takes from other positions onto
the receiving position's device (a real copy where two positions share a
device), folds partial sums in ascending position along the axes (the
order the forest plan's fold over ``model`` takes; not NCCL's ring
order), and records itself once with ``record_collective``: its kind in
the HLO's names, each member's result bytes, the group size and every
position of the mesh as members.  ``moved_bytes`` counts the bytes that
crossed positions.  The controller's read-back (``gather_to``) is an
output copy, not a collective, and is not recorded.  There is no
``torch.distributed`` process group: one controller addresses every
position, as the reference's single-controller jax does.

Autograd runs back through every move (``_Move``): its backward is the
move's transpose, run through this module, so it records itself and
counts its bytes as the forward does: all-gather <-> reduce-scatter,
all-to-all <-> all-to-all with the dimensions swapped, psum <-> psum,
broadcast <-> a sum onto the source.  The rule that keeps gradients
exact: a forward value is either a piece of the whole value (``Sharded``'s
contract) or, just before a ``psum`` / ``reduce_scatter``, one partial
term of it; a COTANGENT is always partial: each position's cotangent
covers only the uses made at that position.  So the transpose of a move
that made copies (a gather, a psum's result) sums its copies'
cotangents once, a local slice's transpose (``relayout``'s narrow, plain
autograd) zero-fills without a sum, and a parameter leaf replicated over
some axes takes the sum of its copies' gradients over those axes once,
at the end (``train/trainer.py``).  A loss read from one position's copy
seeds that copy alone, so no gradient comes out a group's size too
large.

Recording does nothing unless a recorder is set: ``launch/hlo_cost``'s
``CostMode`` sets itself while it counts and clears itself after.  The
slot is one per process, not per thread, so autograd's device thread
records the backward's exchanges too.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.dist.sharding import P, Sharded, coord, group, own_spec

__all__ = ["set_recorder", "recording", "record_collective", "exchange",
           "all_gather", "reduce_scatter", "psum", "pmax", "all_to_all",
           "broadcast", "relayout", "gather_to", "moved_bytes",
           "received_bytes"]

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


# -- moves between positions that own their shards ------------------------------

#: bytes copied from one position's piece to another position since import
_moved = 0


def moved_bytes() -> int:
    """The bytes the functions below have copied across positions."""
    return _moved


def received_bytes(kind: str, nbytes: int, group: int, members: int) -> int:
    """What ``moved_bytes`` counts for one move of this module, from its
    record (``kind``, each member's result bytes ``nbytes``, ``group``,
    ``members``): the bytes every member takes from the other members of
    its group.  An all-gather and an all-to-all take ``(g - 1) / g`` of
    the result and a reduce-scatter ``g - 1`` slices of it: the ring's
    wire bytes, as the record states them.  A ``psum`` / ``pmax`` folds
    every other member's whole term, ``(g - 1) r``, where a ring moves
    ``2 r (g - 1) / g``.  A broadcast copies ``r`` to each member but the
    source.  A psum recorded at ``wire_bytes`` moves its values, not
    those bytes, and ``gather_to`` moves nothing by this count."""
    r, g = int(nbytes), int(group)
    if kind in ("all-gather", "all-to-all"):
        per = r * (g - 1) // g
    elif kind in ("reduce-scatter", "all-reduce"):
        per = r * (g - 1)
    elif kind == "collective-permute":
        return members // g * (g - 1) * r
    else:
        raise ValueError(f"unknown collective kind {kind!r}")
    return members * per


def _recv(t: torch.Tensor, src: tuple, dst: tuple, device) -> torch.Tensor:
    """``t`` (position ``src``'s) as position ``dst`` receives it: on
    ``dst``'s device, counted when it crosses positions."""
    global _moved
    if src != dst:
        _moved += t.numel() * t.element_size()
    return t.to(device)


def _record(kind: str, x: Sharded, out_piece: torch.Tensor, axes,
            nbytes: int | None = None) -> None:
    mesh = x.mesh
    record_collective(kind, out_piece.numel() * out_piece.element_size()
                      if nbytes is None else nbytes,
                      group=_size(mesh, axes), members=mesh.size)


def _size(mesh, axes) -> int:
    n = 1
    for a in axes:
        n *= int(mesh.shape[a])
    return n


def _set_entry(spec: P, dim: int, axes: tuple) -> P:
    entries = list(spec)
    entries[dim] = None if not axes else (axes if len(axes) > 1
                                          else axes[0])
    return P(*entries)


def _dim(x: Sharded, dim: int) -> int:
    return dim % x.ndim


class _Move(torch.autograd.Function):
    """A move whose backward is its transpose: ``fwd`` over the pieces in
    forward, ``bwd`` over the cotangent pieces in backward, both moves of
    this module (each records itself and counts its bytes).  Every piece
    is an input and every result piece an output; ``box`` receives the
    result's spec."""

    @staticmethod
    def forward(ctx, fwd, bwd, box, mesh, spec, keys, *pieces):
        y = fwd(Sharded(mesh, spec, dict(zip(keys, pieces))))
        box["spec"] = y.spec
        ctx.bwd, ctx.out = bwd, (mesh, y.spec, keys)
        return tuple(y.pieces[k] for k in keys)

    @staticmethod
    def backward(ctx, *grads):
        mesh, spec, keys = ctx.out
        g = ctx.bwd(Sharded(mesh, spec, dict(zip(keys, grads))))
        return (None,) * 6 + tuple(g.pieces[k] for k in keys)


def _move(fwd, bwd, x: Sharded) -> Sharded:
    """``fwd(x)``; where autograd records (a piece requires grad), through
    ``_Move``, whose backward runs ``bwd`` on the cotangents."""
    if not (torch.is_grad_enabled()
            and any(t.requires_grad for t in x.pieces.values())):
        return fwd(x)
    keys, box = list(x.pieces), {}
    out = _Move.apply(fwd, bwd, box, x.mesh, x.spec, keys,
                      *x.pieces.values())
    return Sharded(x.mesh, box["spec"], dict(zip(keys, out)))


def all_gather(x: Sharded, dim: int) -> Sharded:
    """Make dimension ``dim`` whole at every position: each position
    concatenates its group's pieces along ``dim`` in position order.  A
    dimension no axis splits comes back as ``x`` itself.  Transpose: the
    reduce-scatter of the cotangents onto the same split."""
    dim = _dim(x, dim)
    return _gather(x, dim, x.entry(dim))


def _gather(x: Sharded, dim: int, axes: tuple) -> Sharded:
    """Gather ``axes``, the minor end of ``dim``'s entry, leaving the
    axes before them on the dimension."""
    if not axes:
        return x
    keep = x.entry(dim)[:len(x.entry(dim)) - len(axes)]
    if _size(x.mesh, axes) == 1:            # each piece is whole already
        return Sharded(x.mesh, _set_entry(x.spec, dim, keep), x.pieces)

    def fwd(v: Sharded) -> Sharded:
        out = {}
        for pos in v.pieces:
            dev = v.mesh.devices[pos]
            out[pos] = torch.cat([_recv(v.pieces[q], q, pos, dev)
                                  for q in group(v.mesh, pos, axes)], dim)
        y = Sharded(v.mesh, _set_entry(v.spec, dim, keep), out)
        _record("all-gather", v, y.first, axes)
        return y

    return _move(fwd, lambda g: reduce_scatter(g, axes, dim), x)


def _fold(parts: list[torch.Tensor]) -> torch.Tensor:
    acc = parts[0].clone() if len(parts) == 1 else parts[0] + parts[1]
    for t in parts[2:]:
        acc = acc + t
    return acc


def psum(x: Sharded, axes, *, wire_bytes: int | None = None) -> Sharded:
    """``x`` holds partial sums along ``axes`` (each position one term of
    the whole value's sum, under the same spec): every position gets the
    sum, folded in ascending position along ``axes``.  Transpose: the
    psum of the cotangents (each copy of the sum was used on its own).
    ``wire_bytes``: what each member's result carries on the wire, where
    the record should say so (the cross-pod all-reduce of int8 levels and
    a scale, ``train/trainer.py``); the move itself is the values'."""
    axes = tuple(a for a in axes if a)
    if _size(x.mesh, axes) == 1:
        return x

    def fwd(v: Sharded) -> Sharded:
        out = {}
        for pos in v.pieces:
            dev = v.mesh.devices[pos]
            out[pos] = _fold([_recv(v.pieces[q], q, pos, dev)
                              for q in group(v.mesh, pos, axes)])
        y = Sharded(v.mesh, v.spec, out)
        _record("all-reduce", v, y.first, axes, wire_bytes)
        return y

    return _move(fwd, lambda g: psum(g, axes), x)


def pmax(x: Sharded, axes) -> Sharded:
    """The elementwise max of ``x``'s pieces over ``axes`` at every
    position, folded in ascending position (the int8 round trip's global
    scale); no gradient."""
    axes = tuple(a for a in axes if a)
    if _size(x.mesh, axes) == 1:
        return x
    out = {}
    for pos in x.pieces:
        dev = x.mesh.devices[pos]
        parts = [_recv(x.pieces[q], q, pos, dev).detach()
                 for q in group(x.mesh, pos, axes)]
        acc = parts[0]
        for t in parts[1:]:
            acc = torch.maximum(acc, t)
        out[pos] = acc
    y = Sharded(x.mesh, x.spec, out)
    _record("all-reduce", x, y.first, axes)
    return y


def reduce_scatter(x: Sharded, axes, dim: int) -> Sharded:
    """The sum of ``x``'s partials along ``axes`` (as ``psum``), each
    position keeping only its slice of dimension ``dim`` (``axes`` added,
    minor, to the dimension's entry): each position folds its slice of
    every member's partial in ascending position.  Transpose: the
    all-gather of the cotangents over ``axes``."""
    axes = tuple(a for a in axes if a)
    dim = _dim(x, dim)
    n = _size(x.mesh, axes)
    spec = _set_entry(x.spec, dim, x.entry(dim) + axes)
    if n == 1:                              # one term: the sum itself
        return Sharded(x.mesh, spec, x.pieces)

    def fwd(v: Sharded) -> Sharded:
        step = v.first.shape[dim] // n
        out = {}
        for pos in v.pieces:
            dev = v.mesh.devices[pos]
            k = coord(v.mesh, pos, axes)
            out[pos] = _fold([_recv(v.pieces[q].narrow(dim, k * step, step),
                                    q, pos, dev)
                              for q in group(v.mesh, pos, axes)])
        y = Sharded(v.mesh, spec, out)
        _record("reduce-scatter", v, y.first, axes)
        return y

    return _move(fwd, lambda g: _gather(g, dim, axes), x)


def all_to_all(x: Sharded, split_dim: int, concat_dim: int) -> Sharded:
    """Move the axes that split ``concat_dim`` onto ``split_dim`` (added,
    minor, to its entry): the position at index j along those axes takes
    slice j of ``split_dim`` from every member and concatenates them along
    ``concat_dim`` in position order.  The exchange of the EP dispatch,
    the turn from a hidden dimension split to a sequence split.
    Transpose: the all-to-all that moves those axes back."""
    split_dim, concat_dim = _dim(x, split_dim), _dim(x, concat_dim)
    return _exchange(x, split_dim, concat_dim, x.entry(concat_dim))


def _exchange(x: Sharded, to_dim: int, from_dim: int, axes: tuple) -> Sharded:
    """Move ``axes``, the minor end of ``from_dim``'s entry, onto the
    minor end of ``to_dim``'s."""
    n = _size(x.mesh, axes)
    keep = x.entry(from_dim)[:len(x.entry(from_dim)) - len(axes)]
    spec = _set_entry(_set_entry(x.spec, from_dim, keep), to_dim,
                      x.entry(to_dim) + axes)
    if n == 1:                              # nothing to exchange
        return Sharded(x.mesh, spec, x.pieces)

    def fwd(v: Sharded) -> Sharded:
        step = v.first.shape[to_dim] // n
        out = {}
        for pos in v.pieces:
            dev = v.mesh.devices[pos]
            k = coord(v.mesh, pos, axes)
            out[pos] = torch.cat([_recv(v.pieces[q].narrow(to_dim, k * step,
                                                           step), q, pos,
                                        dev)
                                  for q in group(v.mesh, pos, axes)],
                                 from_dim)
        y = Sharded(v.mesh, spec, out)
        _record("all-to-all", v, y.first, axes)
        return y

    return _move(fwd, lambda g: _exchange(g, from_dim, to_dim, axes), x)


def broadcast(x: Sharded, axes, src: int = 0) -> Sharded:
    """Every position takes the piece of the member at index ``src`` of
    its group along ``axes`` (a copy, the source's own included).
    Transpose: the group's cotangents summed onto the source (a psum),
    zero at the other members."""
    axes = tuple(a for a in axes if a)
    if _size(x.mesh, axes) == 1:
        return x

    def fwd(v: Sharded) -> Sharded:
        out = {}
        for pos in v.pieces:
            q = group(v.mesh, pos, axes)[src]
            out[pos] = _recv(v.pieces[q], q, pos,
                             v.mesh.devices[pos]).clone()
        y = Sharded(v.mesh, v.spec, out)
        _record("collective-permute", v, y.first, axes)
        return y

    def bwd(g: Sharded) -> Sharded:
        return psum(g, axes).map(
            lambda pos, t: t if coord(g.mesh, pos, axes) == src
            else torch.zeros_like(t))

    return _move(fwd, bwd, x)


def relayout(x: Sharded, spec) -> Sharded:
    """``x`` under ``spec`` (``own_spec``'s rule for uneven dimensions), in
    three steps: a dimension whose axes are needed neither there nor on a
    dimension no axis splits yet is gathered whole; an axis set that
    leaves one dimension for another moves by ``all_to_all``; a dimension
    that gains axes (minor to the ones it keeps) is sliced where it lies,
    which moves nothing.  The FSDP gather of a weight over ``data`` is
    the first step, the turn of a hidden dimension split into a sequence
    split the second.  The slice's transpose is plain autograd's: the
    cotangent zero-filled into the position's piece, no sum (a cotangent
    is partial; the module docstring)."""
    want = own_spec(spec, x.shape, x.mesh)
    need = [tuple(e if isinstance(e, tuple) else ((e,) if e else ()))
            for e in want]

    def have() -> list[tuple]:
        return [x.entry(d) for d in range(x.ndim)]

    def mover(d: int, cur: list) -> int | None:
        for e in range(x.ndim):
            if e != d and need[e] == cur[d] and not cur[e]:
                return e
        return None

    cur = have()
    for d in range(x.ndim):
        if cur[d] and need[d][:len(cur[d])] != cur[d] and \
                mover(d, cur) is None:
            x = all_gather(x, d)
            cur = have()
    for d in range(x.ndim):
        if cur[d] and need[d][:len(cur[d])] != cur[d]:
            x = all_to_all(x, mover(d, cur), d)
            cur = have()
    for d in range(x.ndim):
        add = need[d][len(cur[d]):]
        if add:
            step = x.first.shape[d] // _size(x.mesh, add)
            x = x.map(lambda pos, t, d=d, add=add, step=step: t.narrow(
                d, coord(x.mesh, pos, add) * step, step),
                spec=_set_entry(x.spec, d, need[d]))
    return x


def gather_to(x: Sharded, device) -> torch.Tensor:
    """The whole value on ``device`` (the controller's read-back): each
    dimension's pieces concatenated in position order, one piece a slice
    (replicated copies read once)."""
    mesh = x.mesh
    # the pieces of distinct slices: the positions at index 0 along every
    # axis that splits nothing
    split = [a for d in range(x.ndim) for a in x.entry(d)]
    keep = [q for q in x.pieces
            if all(q[mesh.axis_names.index(a)] == 0
                   for a in mesh.axis_names if a not in split)]

    def build(dim: int, chosen: list[tuple]) -> torch.Tensor:
        if dim == x.ndim:
            return x.pieces[chosen[0]].to(device)
        axes = x.entry(dim)
        if not axes:
            return build(dim + 1, chosen)
        n = _size(mesh, axes)
        return torch.cat([build(dim + 1, [q for q in chosen
                                          if coord(mesh, q, axes) == k])
                          for k in range(n)], dim)

    return build(0, keep)
