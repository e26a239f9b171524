"""Dataflow-graph operators split into pipeline stages (torch).

Mirrors ``repro/db/operators.py`` (netsDB's query compilation model,
paper Sec. 3.1): a plan is a chain of operators; a pipeline breaker
(aggregate / partition / write) ends a stage, and every stage boundary
MATERIALIZES its output.

The reference jits each stage and waits with ``block_until_ready``.  Here a
stage runs its operators eagerly; PyTorch returns before the card has
finished, so the boundary synchronises the device, and on the card the
stage is timed with CUDA events around its work (a host clock without the
synchronise would measure only the enqueue).

Each stage run is a ``stage:<name>`` span (reference ``operators.py:137``):
its host wall includes the boundary's synchronise, and on the card it
carries ``device_s``, the CUDA-event seconds of ``StageReport.seconds``, so
a trace tells the host's turnaround at the boundary from the stage's device
time.  The span adds no event and no synchronise of its own.

On a mesh (``dist/sharding.py``) a stage value may be ``RowShards`` (a
batch's rows over the ``data`` axis, ``db/shards.py``);
``StageReport.devices`` is the number of mesh positions a stage runs at
(reference ``operators.py:95-112``), the largest ``Operator.devices`` of
its operators: the plan gives its mesh operators the mesh's size, and
every other operator is 1.  A stage over several cards is timed on the
stream of the first card it finds; positions that share a card run on its
one stream, so on a one-card mesh the events cover the whole stage.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Sequence

import torch

from repro_torch.db.sparse import CSRPages
from repro_torch.db.shards import RowShards
from repro_torch.obs import TRACER

__all__ = ["Operator", "Stage", "StageReport", "split_into_stages",
           "run_stages"]


@dataclasses.dataclass(frozen=True)
class Operator:
    """One relational operator: ``fn(state) -> state`` over a dict of
    tensors; ``breaker=True`` ends the pipeline stage after it;
    ``devices`` is the number of mesh positions it runs at."""

    name: str
    fn: Callable[[Any], Any]
    breaker: bool = False
    devices: int = 1


@dataclasses.dataclass
class StageReport:
    name: str
    operators: tuple[str, ...]
    seconds: float
    materialized_bytes: int
    devices: int = 1                 # mesh positions the stage runs at


def _tensors(state) -> list[torch.Tensor]:
    """The state's tensors, a CSR page block's three arrays and a sharded
    value's shards included."""
    values = state.values() if isinstance(state, dict) else (state,)
    out = []
    for v in values:
        if isinstance(v, RowShards):
            out.extend(v.tensors())
        elif isinstance(v, CSRPages):
            out.extend(t for t in v.arrays() if isinstance(t, torch.Tensor))
        elif isinstance(v, torch.Tensor):
            out.append(v)
    return out


def _cuda_device(state) -> torch.device | None:
    for t in _tensors(state):
        if t.is_cuda:
            return t.device
    return None


@dataclasses.dataclass
class Stage:
    """A maximal breaker-terminated run of operators, run as one unit."""

    name: str
    operators: Sequence[Operator]

    def _apply(self, state):
        for op in self.operators:
            state = op.fn(state)
        return state

    def run(self, state):
        device = _cuda_device(state)
        with TRACER.span(f"stage:{self.name}") as sp:
            if device is None:
                t0 = time.perf_counter()
                out = self._apply(state)
                seconds = time.perf_counter() - t0
            else:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record(torch.cuda.current_stream(device))
                out = self._apply(state)
                end.record(torch.cuda.current_stream(device))
                end.synchronize()             # stage boundary materializes
                seconds = start.elapsed_time(end) / 1e3
                sp.set(device_s=seconds)
        report = StageReport(
            name=self.name,
            operators=tuple(op.name for op in self.operators),
            seconds=seconds,
            materialized_bytes=sum(t.nbytes for t in _tensors(out)),
            devices=max(op.devices for op in self.operators),
        )
        return out, report


def split_into_stages(ops: Sequence[Operator]) -> list[Stage]:
    """Split an operator chain at breakers (the netsDB compiler rule)."""
    stages: list[Stage] = []
    current: list[Operator] = []
    for op in ops:
        current.append(op)
        if op.breaker:
            stages.append(Stage(f"stage{len(stages)}:{op.name}",
                                tuple(current)))
            current = []
    if current:
        stages.append(Stage(f"stage{len(stages)}:{current[-1].name}",
                            tuple(current)))
    return stages


def run_stages(stages: Sequence[Stage], state
               ) -> tuple[Any, list[StageReport]]:
    reports = []
    for st in stages:
        state, rep = st.run(state)
        reports.append(rep)
    return state, reports
