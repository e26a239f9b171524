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
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Sequence

import torch

__all__ = ["Operator", "Stage", "StageReport", "split_into_stages",
           "run_stages"]


@dataclasses.dataclass(frozen=True)
class Operator:
    """One relational operator: ``fn(state) -> state`` over a dict of
    tensors; ``breaker=True`` ends the pipeline stage after it."""

    name: str
    fn: Callable[[Any], Any]
    breaker: bool = False


@dataclasses.dataclass
class StageReport:
    name: str
    operators: tuple[str, ...]
    seconds: float
    materialized_bytes: int


def _tensors(state) -> list[torch.Tensor]:
    values = state.values() if isinstance(state, dict) else (state,)
    return [v for v in values if isinstance(v, torch.Tensor)]


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
            end.synchronize()                 # stage boundary materializes
            seconds = start.elapsed_time(end) / 1e3
        report = StageReport(
            name=self.name,
            operators=tuple(op.name for op in self.operators),
            seconds=seconds,
            materialized_bytes=sum(t.nbytes for t in _tensors(out)),
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
