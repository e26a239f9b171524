"""Roofline terms and device-calibrated peaks (torch).

Mirrors the calibration half of ``repro/launch/roofline.py``:
``roofline_terms`` turns a cell's FLOPs and bytes into seconds, and
``calibrate_peaks`` measures the effective peaks of one device once per
process, with the reference's microbenchmarks and under its key names (the
v5e spelling, ``peak_flops_bf16`` / ``hbm_bandwidth`` / ``ici_bandwidth``,
so tables stay interchangeable):

  ``peak_flops_bf16``   one f32 512 x 512 matmul (``torch.matmul``);
  ``hbm_bandwidth``     an elementwise add over 32 MiB (read + write);
  ``ici_bandwidth``     the same rate (one device: a collective term moves
                        at memory speed);
  ``gather_bandwidth``  a 16 MiB row gather through numpy-seeded indices;
  ``h2d_bandwidth``     a 16 MiB host -> device copy;
  ``dispatch_s``        one tiny elementwise op, end to end;

plus ``backend`` (the device, e.g. ``"cuda:0"``) and ``measured``.

The port's own shape: tables are keyed by DEVICE (``calibrate_peaks(
device)``), so a CPU store ranks with the CPU's peaks and a CUDA store with
its card's, and no caller falls back from one to the other.  There is no
TPU table and no default peak: ``roofline_terms`` takes ``peak``
explicitly.  On CUDA every timed call ends in ``torch.cuda.synchronize``
(the host clock alone would time the launch), and the H2D source is PINNED
host memory -- the rate the host tier's scan sees (its pages are pinned) --
where the reference times a pageable ``device_put``.

The dry-run's half: ``model_flops`` (6 N D useful FLOPs a step, as the
reference's) and ``CollectiveStats``, the per-kind collective record with
the reference's two conventions.  The reference's ``parse_collectives``
reads them out of compiled HLO text, which the port has none of: its
counterpart is the record ``launch/hlo_cost.analyze`` keeps of the
collectives the port's own code performs (``record_collective``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

__all__ = ["CollectiveStats", "model_flops", "roofline_terms",
           "calibrate_peaks", "resolve_peaks"]


@dataclasses.dataclass
class CollectiveStats:
    """Collective traffic by kind, two conventions:

    operand bytes  what each member CONTRIBUTES (all-gather: its shard;
                   all-reduce: the full buffer; reduce-scatter: the full
                   input; all-to-all / permute: the local buffer);
    wire bytes     a ring algorithm's estimate of what crosses each
                   member's links (all-reduce ~2x the buffer, etc.).
    """
    counts: dict[str, int]
    bytes_by_kind: dict[str, int]       # operand-bytes convention
    wire_bytes_by_kind: dict[str, int]

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())

    @property
    def total_wire_bytes(self) -> int:
        return sum(self.wire_bytes_by_kind.values())

    @property
    def total_count(self) -> int:
        return sum(self.counts.values())


def model_flops(cfg, shape) -> float:
    """6 N D (dense) / 6 N_active D (MoE) useful-model FLOPs a step;
    prefill 2 N D (forward only), decode 2 N x global_batch (one token a
    stream)."""
    n_active = cfg.active_param_count()
    tokens = shape.seq_len * shape.global_batch
    if shape.kind == "train":
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        return 2.0 * n_active * tokens
    return 2.0 * n_active * shape.global_batch


#: one calibrated table per device, measured once per process
_CALIBRATED: dict[str, dict] = {}


def _device(device: str | torch.device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _time_best(fn: Callable[[], None], iters: int = 3) -> float:
    """Min of ``iters`` host-clock walls of ``fn`` (which must end in a
    device synchronise)."""
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def h2d_source(device: str | torch.device) -> torch.Tensor:
    """The 16 MiB host buffer the H2D rate is timed from: pinned for a
    CUDA device (raising if the pin fails), plain memory for the CPU."""
    dev = _device(device)
    host = torch.ones((4 << 20,), dtype=torch.float32,
                      pin_memory=dev.type == "cuda")
    if dev.type == "cuda" and not host.is_pinned():
        raise RuntimeError("the H2D calibration source is not pinned")
    return host


def calibrate_peaks(device: str | torch.device) -> dict:
    """Measure the effective peaks of ``device`` (cached per device).

    Every measurement is min-of-3 (the dispatch probe min-of-5) on small
    operands, after one warm call, so the whole calibration stays near a
    second; the numbers are effective throughputs, not data-sheet peaks.
    """
    dev = _device(device)
    key = str(dev)
    if key in _CALIBRATED:
        return _CALIBRATED[key]
    if dev.type == "cuda":
        def sync() -> None:
            torch.cuda.synchronize(dev)
    else:
        def sync() -> None:
            pass

    def timed(op: Callable[[], object], iters: int = 3) -> float:
        def run() -> None:
            op()
            sync()
        run()                                   # warm
        return _time_best(run, iters)

    # FLOP/s: one f32 [N, N] @ [N, N] matmul, 2 N^3 useful flops
    n = 512
    a = torch.ones((n, n), dtype=torch.float32, device=dev)
    peak_flops = 2.0 * n ** 3 / max(timed(lambda: torch.matmul(a, a)), 1e-9)

    # streaming bandwidth: elementwise add over 32 MiB (1 read + 1 write)
    big = torch.ones((8 << 20,), dtype=torch.float32, device=dev)
    stream_bw = 2.0 * big.nbytes / max(timed(lambda: big + 1.0), 1e-9)

    # gather bandwidth: a 16 MiB row gather through random indices, the
    # access pattern of node / threshold lookups
    rows = 1 << 16
    table = torch.ones((rows, 64), dtype=torch.float32, device=dev)
    idx = torch.as_tensor(np.random.default_rng(0).integers(0, rows, rows),
                          dtype=torch.int64, device=dev)
    gather_bw = 2.0 * table.nbytes / max(
        timed(lambda: torch.index_select(table, 0, idx)), 1e-9)

    # host -> device: a 16 MiB copy out of the (pinned) host buffer
    host = h2d_source(dev)
    dst = torch.empty_like(host, device=dev)
    h2d_bw = host.nbytes / max(timed(
        lambda: dst.copy_(host, non_blocking=dev.type == "cuda")), 1e-9)

    # dispatch overhead: one tiny elementwise op, end to end
    tiny = torch.ones((8,), dtype=torch.float32, device=dev)
    dispatch_s = timed(lambda: tiny + 1.0, iters=5)

    peaks = {
        "peak_flops_bf16": peak_flops,
        "hbm_bandwidth": stream_bw,
        # one device: inter-device traffic moves at memory speed, which
        # keeps collective terms finite and comparable
        "ici_bandwidth": stream_bw,
        "gather_bandwidth": gather_bw,
        "h2d_bandwidth": h2d_bw,
        "dispatch_s": dispatch_s,
        "backend": key,
        "measured": True,
    }
    _CALIBRATED[key] = peaks
    return peaks


def resolve_peaks(device: str | torch.device) -> dict:
    """The peaks table cost ranking uses on ``device``: its calibrated
    table (there is no published table to prefer)."""
    return calibrate_peaks(device)


def roofline_terms(*, flops_per_chip: float, bytes_per_chip: float,
                   coll_bytes_per_chip: float, peak: dict) -> dict:
    """Compute, memory and collective seconds of one step on one device,
    the dominant term's name and the step's lower bound (their max)."""
    compute_s = flops_per_chip / peak["peak_flops_bf16"]
    memory_s = bytes_per_chip / peak["hbm_bandwidth"]
    coll_s = coll_bytes_per_chip / peak["ici_bandwidth"]
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": coll_s}
    dominant = max(terms, key=terms.get)
    bound = max(terms.values())
    terms["dominant"] = dominant
    terms["step_s_lower_bound"] = bound
    return terms
