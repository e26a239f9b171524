"""Probe the host-tier scan on one NVIDIA GPU: its times in a fresh process
under controlled conditions, and whether a torch.profiler trace holds
every page copy.

    python3 chip_tiers_probe.py [--reps 4] [--trace-dir DIR]

It makes chip_smoke.py's seeded 11,000,000 x 28 table and its 500- and
1600-tree forests, and puts the table on the pinned host tier of a store
with a 256 MiB device budget (the auto cascade; 10 batches of 1,170
pages).  In each condition below, cumulative and in this order, it runs
infer(plan="udf", algorithm="predicated_pallas_fused") and
infer(plan="rel+reuse", algorithm="predicated_pallas") ``--reps`` times
each at prefetch depth 2 and prints every run's scan times:

  fresh        nothing else in the process;
  profiled     after torch.profiler traces of the udf query: three, then
               one of rel+reuse, one more of udf, and one of udf right
               after chip_smoke's link-rate copies (and, under +disk, one
               after a disk-tier scan), each summarised as chip_smoke's
               phase 8
               summarises its own (busy share, time before the first
               kernel, time between kernels), and its host-to-device
               copies counted three ways: by ``prof.events()`` (what
               chip_smoke reads), by the raw kineto events, and in the
               exported Chrome trace with their bytes;
  gc           after gc.collect();
  gc-off       with the collector disabled for the runs;
  +disk        with chip_smoke's disk-tier copy of the table stored too;
  +device      with the table also on a device-tier store, queried by
               both plans (chip_smoke's reference runs);
  interleaved  udf at depths 2, 2, 1, 2, 1 as chip_smoke's phase 8 runs
               them, each followed by a device synchronise.

Each condition also prints the card's SM clock, temperature and power
draw.  It imports nothing of the JAX package.  ``--trace-dir`` keeps the
Chrome traces (else they go to a temporary directory that is deleted).
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs


def smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def h2d_counts(prof, path: str) -> dict:
    """The trace's host-to-device copies: (count, union ms) from
    ``prof.events()`` and from the kineto events, and (count, bytes) from
    the Chrome trace written to ``path``."""
    from torch.autograd import DeviceType

    _, _, spans = cs.device_intervals(prof)
    raw = [(e.start_ns() / 1e3, (e.start_ns() + e.duration_ns()) / 1e3)
           for e in prof.profiler.kineto_results.events()
           if e.device_type() == DeviceType.CUDA and "HtoD" in e.name()]
    prof.export_chrome_trace(path)
    with open(path) as fh:
        trace = json.load(fh)
    copies = [e for e in trace.get("traceEvents", [])
              if e.get("cat") == "gpu_memcpy" and "HtoD" in e.get("name", "")]
    return dict(events=(len(spans), cs.union_us(spans) / 1e3),
                kineto=(len(raw), cs.union_us(raw) / 1e3),
                chrome=(len(copies), sum(int(e.get("args", {}).get(
                    "bytes", 0)) for e in copies)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=4)
    ap.add_argument("--trace-dir", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_tiers_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.forest import make_forest
    from repro_torch.db.store import TensorBlockStore
    from repro_torch.kernels import _build

    card = cs.nvidia_smi_line()
    cs.log(f"[probe] {card}; torch {torch.__version__} cuda "
           f"{torch.version.cuda}; nvcc build {_build.build_all():.3f} s")
    fe, th, dl, lv = cs.make_forest_arrays(np.random.default_rng(cs.SEED + 2),
                                           integer_leaves=False)
    forest = make_forest(fe, th, lv, default_left=dl,
                         n_features=cs.FEATURES, model_type="xgboost",
                         task="classification", device="cuda")
    fe, th, dl, lv = cs.make_forest_arrays(
        np.random.default_rng(cs.SEED + 3), integer_leaves=False,
        trees=cs.REL_TREES,
        leaf_scale=0.1 * math.sqrt(cs.TREES / cs.REL_TREES))
    big = make_forest(fe, th, lv, default_left=dl, n_features=cs.FEATURES,
                      model_type="xgboost", task="classification",
                      device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    rows = torch.randn((cs.HIGGS_ROWS, cs.FEATURES), generator=gen,
                       device="cuda")
    host = TensorBlockStore(device="cuda",
                            device_budget_bytes=cs.TIER_BUDGET)
    table = host.put("higgs", rows)
    if table.tier != "host" or not table.data.is_pinned():
        raise AssertionError(f"the table landed on {table.tier}")
    engine = cs.fresh_engine(host)
    queries = {"udf": (forest, "predicated_pallas_fused"),
               "rel+reuse": (big, "predicated_pallas")}

    def query(plan: str, depth: int = 2, eng=engine):
        f, algorithm = queries[plan]
        return eng.infer("higgs", f, plan=plan, algorithm=algorithm,
                         prefetch_depth=depth)

    def series(label: str, runs=None) -> None:
        cs.log(f"[probe] {label}: card {smi('clocks.sm,temperature.gpu,'
                                            'power.draw')}")
        for plan, depth in runs or [(p, 2) for p in queries
                                    for _ in range(args.reps)]:
            s = query(plan, depth).scan
            torch.cuda.synchronize()
            cs.log(f"[probe] {label} host {plan} depth {depth}: wall_s "
                   f"{s.wall_s:.6f}, compute_s {s.compute_s:.6f}, "
                   f"transfer_wait_s {s.transfer_wait_s:.6f}, "
                   f"transfer_issue_s {s.transfer_issue_s:.6f}, "
                   f"drain_wait_s {s.drain_wait_s:.6f}, {s.batches} "
                   f"batches; on {card}")

    for plan in queries:                       # warm-up: builds the plans
        query(plan)
    torch.cuda.synchronize()
    series("fresh")

    trace_dir = args.trace_dir or tempfile.mkdtemp(prefix="probe-trace-")
    os.makedirs(trace_dir, exist_ok=True)
    spill = tempfile.mkdtemp(prefix="probe-spill-")
    try:
        def trace(i: int, plan: str) -> None:
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                batches = query(plan).scan.batches
                torch.cuda.synchronize()
                wall_us = (time.perf_counter() - t0) * 1e6
            n = h2d_counts(prof, os.path.join(trace_dir,
                                              f"trace{i}_{plan}.json"))
            cs.log(f"[probe] trace {i} host {plan}: "
                   f"{cs.scan_trace(prof, wall_us)}; {batches} batches, "
                   f"{table.nbytes} B of pages; H2D copies by "
                   f"prof.events() {n['events'][0]} ({n['events'][1]:.3f} "
                   f"ms), by kineto {n['kineto'][0]} "
                   f"({n['kineto'][1]:.3f} ms), in the Chrome trace "
                   f"{n['chrome'][0]} ({n['chrome'][1]} B); on {card}")

        for i, plan in enumerate(("udf", "udf", "udf", "rel+reuse", "udf")):
            trace(i, plan)
        src = torch.empty(cs.LINK_BYTES // 4, pin_memory=True)
        dst = torch.empty(cs.LINK_BYTES // 4, device="cuda")
        cs.cuda_ms(lambda: dst.copy_(src, non_blocking=True), warmup=2,
                   reps=10)                    # chip_smoke's link rate
        del src, dst
        trace(5, "udf")
        series("profiled")
        gc.collect()
        series("gc")
        gc.disable()
        try:
            series("gc-off")
        finally:
            gc.enable()
        disk = TensorBlockStore(device="cuda",
                                device_budget_bytes=cs.TIER_BUDGET,
                                host_budget_bytes=cs.TIER_BUDGET,
                                spill_dir=spill)
        if disk.put("higgs", rows).tier != "disk":
            raise AssertionError("the disk store's table is not on disk")
        series("+disk")
        disk_engine = cs.fresh_engine(disk)
        query("udf", eng=disk_engine)          # the reader thread's copies
        trace(6, "udf")
        device = TensorBlockStore(device="cuda")
        device.put("higgs", rows)
        on_card = cs.fresh_engine(device)
        for plan in queries:
            query(plan, eng=on_card)
        torch.cuda.synchronize()
        series("+device")
        series("interleaved", [("udf", d) for d in (2, 2, 1, 2, 1)])
        disk.drop("higgs")
    finally:
        shutil.rmtree(spill, ignore_errors=True)
        if args.trace_dir is None:
            shutil.rmtree(trace_dir, ignore_errors=True)
    cs.log(f"[probe] done on {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
