"""Fault-tolerant training loop: checkpoint / restart, failure injection,
straggler flags (torch).

Mirrors ``repro/train/fault.py``.  The loop rests on three invariants:

  1. deterministic data  -- batch k is a pure function of (seed, k)
                           (``train/data.py``), so any restart replays it;
  2. atomic checkpoints  -- a save every ``ckpt_every`` steps and one at
                           the end, crash-safe (``train/checkpoint.py``);
  3. deterministic steps -- on the card each step runs under
                           ``torch.use_deterministic_algorithms``
                           (``train/trainer.py``), so a restored run
                           continues bit for bit.

Stragglers appear as slow steps: the loop keeps an EWMA of step time
(the first step, which warms up, left out) and flags a step past
``straggler_factor`` x the EWMA once three steps have run, calling
``on_straggler``.  ``FailureInjector`` raises at a chosen step to simulate
a node loss.  Reading a step's loss (``float``) is the step's one
synchronise.  ``restore(mesh=)`` reshards onto the current mesh, as the
reference's elastic restart does.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

from repro_torch.train.checkpoint import restore_checkpoint, save_checkpoint

__all__ = ["FailureInjector", "TrainLoop", "LoopReport"]


class FailureInjector:
    """Raises RuntimeError at step ``fail_at`` (once)."""

    def __init__(self, fail_at: int | None = None):
        self.fail_at = fail_at
        self.fired = False

    def maybe_fail(self, step: int):
        if self.fail_at is not None and step == self.fail_at \
                and not self.fired:
            self.fired = True
            raise RuntimeError(f"injected node failure at step {step}")


@dataclasses.dataclass
class LoopReport:
    steps_run: int
    final_step: int
    losses: list[float]
    step_times: list[float]
    stragglers: list[int]
    restored_from: int | None = None


class TrainLoop:
    """Deterministic, restartable training loop."""

    def __init__(self, step_fn: Callable, batch_fn: Callable[[int], Any],
                 *, ckpt_dir: str | None = None, ckpt_every: int = 50,
                 straggler_factor: float = 3.0,
                 on_straggler: Callable[[int, float], None] | None = None,
                 injector: FailureInjector | None = None):
        self.step_fn = step_fn
        self.batch_fn = batch_fn
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        self.straggler_factor = straggler_factor
        self.on_straggler = on_straggler
        self.injector = injector

    def run(self, state: Any, num_steps: int, *,
            start_step: int | None = None) -> tuple[Any, LoopReport]:
        step = int(start_step) if start_step is not None \
            else int(state["step"])
        losses, times, stragglers = [], [], []
        ewma = None
        end = step + num_steps
        while step < end:
            if self.injector is not None:
                self.injector.maybe_fail(step)
            batch = self.batch_fn(step)
            t0 = time.perf_counter()
            state, metrics = self.step_fn(state, batch)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            losses.append(loss)
            times.append(dt)
            # the first step warms up: leave it out of the EWMA
            if len(times) > 1:
                if ewma is not None and dt > self.straggler_factor * ewma \
                        and len(times) > 3:
                    stragglers.append(step)
                    if self.on_straggler:
                        self.on_straggler(step, dt)
                ewma = dt if ewma is None else 0.9 * ewma + 0.1 * dt
            step += 1
            if self.ckpt_dir and step % self.ckpt_every == 0:
                save_checkpoint(self.ckpt_dir, state, step)
        if self.ckpt_dir:
            save_checkpoint(self.ckpt_dir, state, step)
        return state, LoopReport(steps_run=num_steps, final_step=step,
                                 losses=losses, step_times=times,
                                 stragglers=stragglers)

    def restore(self, like: Any, *, mesh=None) -> tuple[Any, int]:
        """Restart: the latest checkpoint in ``like``'s dtypes, onto its
        devices, or resharded onto ``mesh``."""
        assert self.ckpt_dir is not None
        return restore_checkpoint(self.ckpt_dir, like, mesh=mesh)
