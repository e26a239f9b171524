"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. report   the card's name, the device count, name and power limit;
  2. build    the CUDA kernels from src/repro_torch/kernels/csrc with nvcc
              (each library holds one kernel's fused and raw entry points);
  3. kernels  each fused and each raw kernel against its plain PyTorch
              version at depth 8, 500 trees, 28 features on 16,421 rows
              (a ragged last block) with NaN rows: fused sums bit-identical
              on integer leaves and within TOL on float leaves, raw [B, T]
              scores bit-identical (bit for bit, sign of zero included);
              then every kernel, fused and raw, at shallower depths with
              -0.0 leaves, all bit for bit: predicated and HummingBird at
              1, 3 and 5, QuickScorer at 1, 3, 5 and 6 (the first depth
              whose top node clears a whole 32-leaf word); then the wide
              rows: at F = 968, 1,185, 2,000, 4,096 and 10,000 every
              kernel, fused and raw, in the wide-row x mode and (where a
              32-sample tile fits) staged, at depth 8 on 16,421 rows with
              NaN rows, and from 1,185 up the shallower depths with -0.0
              leaves likewise, all bit for bit; then the three fused
              kernels over bf16 tree tiles (tree_dtype=torch.bfloat16: a
              4-byte node record and bf16 leaves), bit for bit against
              their plain versions: on the 16,421 rows at depth 8, at the
              shallower depths with -0.0 leaves, at F = 968 and 2,000 in
              both x modes, and over 40,000 features (past the narrow
              record, so the 8-byte one);
  4. path     the in-database query on a HIGGS-shaped table (11,000,000 x
              28 rows from a seed, on the device tier):
              infer(plan="udf", algorithm="predicated_pallas_fused") twice
              (the second must hit the plan cache), launches counted,
              predictions held against the eager "predicated" algorithm;
              then the HummingBird and QuickScorer kernels over 1,000,000
              rows of the same table;
  5. timing   each fused kernel at the shapes the path gave it (CUDA events
              over warmed-up repeats) beside its bound and its plain
              version; then bf16 tree tiles: predict_sum_pallas(...,
              tree_dtype=torch.bfloat16) for each fused kernel at those
              shapes and at Epsilon's 100,352 x 2,000 (wide-row), counted,
              bit for bit the f32 path over the bf16-rounded forest, and
              each bf16 kernel timed beside the f32 one;
  6. rel      the relation-centric plans at the large-model shape (1600
              depth-8 trees): infer(plan="rel+reuse",
              algorithm="predicated_pallas") twice over the 11M-row table
              (the repeat hits the model and the plan cache), plan="rel"
              once, infer_rows at 8/32/128 rows (udf with the fused kernel,
              rel+reuse with the raw one, each called twice), the
              HummingBird and QuickScorer raw kernels through rel+reuse on
              the 1M-row cut (twice each: the repeat is the query time),
              and udf with predicated_pallas (one raw launch over all 1600
              trees) on that cut.  Every query counts its own launches
              (raw = n_parts x scan batches, no other kernel) and holds its
              first rows against the eager oracle;
  7. timing   each raw kernel at one rel launch's shape (16 trees);
  8. tiers    the same 11M-row table off the card: a store with a 256 MiB
              device budget (the auto cascade puts it on the pinned host
              tier) and one with 256 MiB host and device budgets (disk
              tier, mmap page files in a temporary spill directory deleted
              at the end).  udf "predicated_pallas_fused" at 500 trees
              over both, at prefetch depths 2 and 1, and rel+reuse
              "predicated_pallas" at 1600 trees twice over the host tier,
              each bit-identical to the device tier at the same batch
              (10 batches of 1,170 pages), with exact launch counts; the
              scan's telemetry, the overlap fraction, the link rate of one
              pinned 128 MiB H2D copy and the scan's bound; a
              torch.profiler trace of one host-tier query, before any
              disk-tier scan (device busy share, the device's wait before
              and between the kernels, H2D overlapping the kernel, flagged
              when it misses page copies); a move round trip device ->
              host -> disk -> device on the 1M-row cut;
  9. sparse   wide rows and the CSR plane.  x modes: each kernel, fused
              (500 trees) and raw (16), staged and wide-row, on 65,536
              rows at widths from 28 to 10,000, beside its bound, and each
              kernel's crossover.  Epsilon (100,000 x 2,000 dense, device
              tier): udf with the three fused kernels, rel+reuse with
              predicated_pallas twice (the repeat hits both caches) and
              with the raw HummingBird and QuickScorer kernels, each held
              against the eager oracle; the wide-row kernels timed at that
              shape.  Bosch (1,184,000 x 968, 81 % missing) dense and as
              CSR on the device tier, both on the pinned host tier (256 MiB
              device budget) and the CSR copy on the disk tier: udf with
              the fused predicated and HummingBird kernels, rel+reuse
              predicated_pallas twice, each CSR result bit for bit the
              device tier's dense one, with a trace of each host-tier udf
              scan.  Criteo-shaped (2,000,000 x 10,000, 96 % missing, CSR
              made on the card in 64-page chunks, 6.4 GB on the device
              tier): udf with the fused predicated and HummingBird kernels
              at 64 pages a batch, the gather's share of the stage time,
              and both held bit for bit against the dense plane over the
              first 65,536 rows, densified on the card.
 10. load     the paper's external load against in-database inference.
              HIGGS 1,000,000 x 28 written as CSV, load_csv_external, then
              the fused predicated kernel + postprocess over the loaded
              rows at 10 and 500 depth-8 trees, against infer(plan="udf")
              over the same rows put on the device tier: both stage
              breakdowns, the ratio, predictions bit-identical.  A
              Criteo-shaped LIBSVM file (20,000 x 10,000 at 96 % missing)
              loaded by load_libsvm_csr_external onto the device, host and
              disk tiers and put_sparse(pages=) zero-copy, udf predicated
              and HummingBird over each, bit for bit put_sparse(data=) of
              the same rows; the dense fallback load_libsvm_external beside
              it.  Epsilon 10,000 x 2,000 as array rows through
              load_array_rows_external and udf predicated (wide-row).
              Writing the files is untimed set-up; they go to a temporary
              directory deleted at the end.
The last lines are the kernels' JSON record (each kernel twice: staged x,
timed at the HIGGS shapes, and ``<name>_wide``, timed at the Epsilon
shape; each fused kernel a third time as ``<name>_bf16``, over bf16 tree
tiles at the HIGGS shapes), the nvidia-smi line, and {"ok": true,
"device": {...}}.

It imports nothing of the JAX package.  The forests' weights and the tables
are random, made from SEED on the card, at the published shapes (depth-8
XGBoost trees, 500 and 1600 for the rel plans; HIGGS's 28 features,
Epsilon's 2,000, Bosch's 968, Criteo's 10,000 of DATASETS).
"""

from __future__ import annotations

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

SEED = 0
DEPTH, TREES, FEATURES = 8, 500, 28
REL_TREES = 1600                # the large-model regime of the rel plans
HIGGS_ROWS = 11_000_000
CUT_ROWS = 1_000_000            # HummingBird / QuickScorer path rows
CHECK_ROWS = 16_421             # phase 3 kernel-vs-plain rows (ragged)
#: phase 3 depths beside DEPTH; QuickScorer adds 6, where its top node
#: first clears a whole word
SHALLOW = dict(predicated=(1, 3, 5), hummingbird=(1, 3, 5),
               quickscorer=(1, 3, 5, 6))
#: phase 3's wide-row checks (all but Bosch's 968 also at SHALLOW depths)
WIDE_CHECK_F = (968, 1185, 2000, 4096, 10000)
COMPARE_ROWS = 65_536           # path rows held against the oracle
ROW_BATCHES = (8, 32, 128)      # the serving plane's bucket ladder
TOL = 1e-6                      # rtol = atol for float sums (order differs)
TIER_BUDGET = 256 << 20         # phase 8's device (and host) budget
LINK_BYTES = 128 << 20          # phase 8's plain pinned H2D copy
MOVE_BATCH_PAGES = 100          # phase 8's move round trip, 1M-row cut
PROFILE_H2D_SHARE = 0.75        # least H2D time of a complete phase 8
#                                 trace, as a share of bytes / link rate
#: phase 9: the x-mode timings' widths and rows (65,536 rows: 500 trees
#: fused, one 16-tree partition raw)
XMODE_F = (28, 200, 400, 512, 640, 768, 968, 1184, 1536, 2000, 10000)
XMODE_ROWS = 65_536
#: phase 9's tables, at the datasets' shapes (src/repro/db/loader.py:
#: DATASETS): Epsilon dense at its full 100,000 x 2,000; Bosch at its full
#: 1,184,000 x 968 with 81 % missing; Criteo-shaped 10,000 features at 96 %
#: missing, cut from 51M to 2M rows
EPSILON_ROWS, EPSILON_F = 100_000, 2000
BOSCH_ROWS, BOSCH_F, BOSCH_MISSING = 1_184_000, 968, 0.81
CRITEO_ROWS, CRITEO_F, CRITEO_MISSING = 2_000_000, 10_000, 0.96
CRITEO_BATCH_PAGES = 64         # pages of 1,024 rows a scan batch
#: phase 3's bf16 checks: the wide-row widths, and a width past the narrow
#: record's 32,768 features
BF16_WIDE_F = (968, 2000)
BF16_PAST_NARROW_F = 40_000
#: phase 10's tables, cut to fit the phase's ~90 s beside the text parse
#: (HIGGS from 11M rows, Criteo-shaped from 51M, Epsilon from 100,000)
LOAD_HIGGS_ROWS = 1_000_000
LOAD_TREES = (10, 500)          # the paper's small- and large-model ends
LOAD_CRITEO_ROWS = 20_000
LOAD_CRITEO_BATCH_PAGES = 4
LOAD_EPSILON_ROWS = 10_000
PAGE_ROWS = 1024                # the store's default page
HBM_BYTES_PER_S = 3.35e12       # H100 SXM, NVIDIA data sheet
SCALAR_OPS_PER_S = 67e12        # f32 outside the tensor cores
INT8_TENSOR_OPS_PER_S = 1979e12  # dense int8 tensor-core rate

KINDS = ("predicated", "hummingbird", "quickscorer")
SOURCES = {k: f"src/repro_torch/kernels/csrc/forest_{k}.cu" for k in KINDS}
REPLACES = {
    "predicated": "src/repro/kernels/forest_predicated.py:143",
    "hummingbird": "src/repro/kernels/forest_hummingbird.py:139",
    "quickscorer": "src/repro/kernels/forest_quickscorer.py:172",
}
RAW_REPLACES = {
    "predicated": "src/repro/kernels/forest_predicated.py:110",
    "hummingbird": "src/repro/kernels/forest_hummingbird.py:115",
    "quickscorer": "src/repro/kernels/forest_quickscorer.py:142",
}


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def make_forest_arrays(rng, *, integer_leaves: bool, trees: int = TREES,
                       leaf_scale: float = 0.1, depth: int = DEPTH,
                       features: int = FEATURES):
    I, L = (1 << depth) - 1, 1 << depth
    feature = rng.integers(0, features, (trees, I)).astype(np.int32)
    threshold = rng.normal(size=(trees, I)).astype(np.float32)
    default_left = rng.random((trees, I)) < 0.5
    if integer_leaves:
        leaves = rng.integers(-8, 9, (trees, L)).astype(np.float32)
    else:
        leaves = (leaf_scale * rng.normal(size=(trees, L))).astype(
            np.float32)
    return feature, threshold, default_left, leaves


def card_rows(rows: int, features: int, *, seed: int, missing: float = 0.0,
              nan_every: int = 0) -> torch.Tensor:
    """[rows, features] f32 made on the card from ``seed``: normal values,
    each missing (NaN) with probability ``missing``, and every
    ``nan_every``-th row all NaN."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((rows, features), generator=gen, device="cuda")
    if missing:
        x[torch.rand((rows, features), generator=gen, device="cuda")
          < missing] = float("nan")
    if nan_every:
        x[::nan_every] = float("nan")
    return x


def stage_sums(r) -> str:
    """A query's stage reports summed by stage name: "name n x total s"."""
    sums: dict[str, list] = {}
    for rep in r.stage_reports:
        entry = sums.setdefault(rep.name, [0, 0.0])
        entry[0] += 1
        entry[1] += rep.seconds
    return ", ".join(f"{name} {n} x {sec:.6f} s"
                     for name, (n, sec) in sums.items())


def pinned_bytes() -> str:
    """The pinned host allocator's bytes (current / peak), where this
    torch reports them."""
    stats = getattr(torch.cuda, "host_memory_stats", None)
    if stats is None:
        return "pinned total not reported by this torch"
    st = stats()
    return (f"pinned allocator {st.get('allocated_bytes.current', 'n/a')} B "
            f"now, {st.get('allocated_bytes.peak', 'n/a')} B peak")


def bits(t: torch.Tensor) -> torch.Tensor:
    """A float tensor's bits, so that equality is bit for bit."""
    return t.contiguous().view(torch.int32)


def cuda_ms(fn, *, warmup: int, reps: int) -> float:
    """Mean milliseconds of ``fn`` on the card, CUDA events, warmed up."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def plain_rows(plain, args, depth: int, rows: int) -> torch.Tensor:
    """A plain version over all rows of args[0], ``rows`` at a time (its
    per-row arithmetic does not depend on the chunking)."""
    x = args[0]
    return torch.cat([plain(x[lo:lo + rows], *args[1:], depth=depth)
                      for lo in range(0, x.shape[0], rows)])


def timed_plain(plain, args, depth: int) -> tuple[torch.Tensor, float]:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    want = plain_rows(plain, args, depth, rows=262_144)
    end.record()
    end.synchronize()
    return want, start.elapsed_time(end)


def bound(kind: str, B: int, F: int, T: int = TREES, *,
          raw: bool = False, record: int = 8) -> tuple[float, str, dict]:
    """Least time (ms) the card could take for one launch over B rows and
    T trees: the larger of bytes over HBM rate and operations over peak.
    Bytes: x read once, the trees (a ``record``-byte node record per node
    slot and a leaf of half that: 12 bytes a slot, 6 over bf16 tiles) and
    the structure tensors a kernel reads once, the output ([B], or [B, T]
    for a raw launch) written once."""
    from repro_torch.core.forest import qs_bitvectors

    I, L = (1 << DEPTH) - 1, 1 << DEPTH
    W = (L + 31) // 32
    nbytes = (4 * B * F + T * (record + record // 2) * L
              + 4 * B * (T if raw else 1))
    pairs = B * T
    add = 0 if raw else 1         # the fused kernels add each pair's leaf
    if kind == "predicated":      # depth compares (+ 1 add) per pair
        ops, rate = pairs * (DEPTH + add), SCALAR_OPS_PER_S
    elif kind == "hummingbird":   # S.C contraction: I x L MACs per pair
        ops, rate = pairs * I * L * 2, INT8_TENSOR_OPS_PER_S
        nbytes += max(32, L) * max(8, L) + 4 * max(8, L)   # C^T int8, D
    else:   # I compares + an AND per mask word not all-ones + W ffs (+ 1)
        masks = int((qs_bitvectors(DEPTH) != 0xFFFFFFFF).sum())
        ops, rate = pairs * (I + masks + W + add), SCALAR_OPS_PER_S
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / rate * 1e3
    by = "bytes" if bytes_ms >= ops_ms else "operations"
    return max(bytes_ms, ops_ms), by, dict(bytes=nbytes, ops=ops,
                                           bytes_ms=bytes_ms, ops_ms=ops_ms)


def traced(run):
    """``run()`` under torch.profiler: (the profile, wall microseconds)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    return prof, wall_us


def log_device_time(prof, top: int) -> None:
    """The trace's device time by kernel (and copy) name, largest first."""
    from torch.autograd import DeviceType

    by_name: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            entry = by_name.setdefault(e.name[:90], [0, 0.0])
            entry[0] += 1
            entry[1] += e.time_range.elapsed_us()
    for kname, (n, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1]
                                 )[:top]:
        log(f"[profile]   {us / 1e3:10.3f} ms  {n:5d} x  {kname}")


def profile_query(run, what: str, smi: str, top: int = 8) -> None:
    """One run under torch.profiler: device time by kernel and the share
    of the run's wall time the card was busy (kernels do not overlap on
    the one stream)."""
    from torch.autograd import DeviceType

    prof, wall_us = traced(run)
    busy_us = sum(e.time_range.elapsed_us() for e in prof.events()
                  if e.device_type == DeviceType.CUDA)
    log(f"[profile] {what}: wall {wall_us / 1e3:.3f} ms under the profiler, "
        f"device busy {busy_us / 1e3:.3f} ms = {100 * busy_us / wall_us:.1f} "
        f"% (idle {100 - 100 * busy_us / wall_us:.1f} %), on {smi}")
    log_device_time(prof, top)


def device_intervals(prof) -> tuple[list, list, list]:
    """(all, kernel, host-to-device copy) device intervals of a trace, in
    microseconds."""
    from torch.autograd import DeviceType

    every, kernels, h2d = [], [], []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        span = (e.time_range.start, e.time_range.end)
        every.append(span)
        if e.name.startswith("Memcpy"):
            if "HtoD" in e.name:
                h2d.append(span)
        elif not e.name.startswith("Memset"):
            kernels.append(span)
    return every, kernels, h2d


def union_us(spans: list) -> float:
    total, end = 0.0, -math.inf
    for lo, hi in sorted(spans):
        if hi > end:
            total += hi - max(lo, end)
            end = hi
    return total


def overlap_us(a: list, b: list) -> float:
    """Time during which an interval of ``a`` and one of ``b`` both run."""
    return union_us(a) + union_us(b) - union_us(a + b)


def scan_trace(prof, wall_us: float) -> str:
    """One scan's trace, summarised: the device busy share of the wall,
    how long before the first kernel the device started (the first
    batch's copy), how long no kernel ran between the first and the last
    (the host's turnaround at each batch's stage boundary), and the page
    copies and their overlap with the kernels."""
    every, kernels, h2d = device_intervals(prof)
    busy = union_us(every)
    k_lo = min(lo for lo, _ in kernels)
    k_hi = max(hi for _, hi in kernels)
    return (f"wall {wall_us / 1e3:.3f} ms under the profiler, device busy "
            f"{busy / 1e3:.3f} ms = {100 * busy / wall_us:.1f} % (idle "
            f"{100 - 100 * busy / wall_us:.1f} %); first kernel "
            f"{(k_lo - min(lo for lo, _ in every)) / 1e3:.3f} ms after the "
            f"first device event, no kernel running for "
            f"{(k_hi - k_lo - union_us(kernels)) / 1e3:.3f} ms between the "
            f"first kernel and the last; kernels {union_us(kernels) / 1e3:.3f}"
            f" ms over {len(kernels)} launches, Memcpy HtoD "
            f"{union_us(h2d) / 1e3:.3f} ms over {len(h2d)} copies, HtoD "
            f"overlapping a kernel {overlap_us(kernels, h2d) / 1e3:.3f} ms")


def tiers_phase(*, forest, big, store, engine, counted, only, smi: str,
                fused_ms: float, rel_device_s: float) -> dict:
    """Phase 8: the 11M-row table on the host and disk tiers.  Returns the
    launches of its queries by kernel."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.db.query import ForestQueryEngine
    from repro_torch.db.store import TensorBlockStore

    launches: dict[str, int] = {}
    table = store.get("higgs")
    rows = table.data[:HIGGS_ROWS]
    batch_pages = (TIER_BUDGET // 2) // table.page_nbytes
    batches = -(-table.num_pages // batch_pages)
    spill = tempfile.mkdtemp(prefix="chip-smoke-spill-")
    try:
        t0 = time.perf_counter()
        host_store = TensorBlockStore(device="cuda",
                                      device_budget_bytes=TIER_BUDGET)
        hds = host_store.put("higgs", rows)
        host_put_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        disk_store = TensorBlockStore(device="cuda",
                                      device_budget_bytes=TIER_BUDGET,
                                      host_budget_bytes=TIER_BUDGET,
                                      spill_dir=spill)
        dds = disk_store.put("higgs", rows)
        disk_put_s = time.perf_counter() - t0
        if (hds.tier, dds.tier) != ("host", "disk"):
            raise AssertionError(f"auto cascade put the table on "
                                 f"{hds.tier} and {dds.tier}")
        if not host_store.get("higgs").data.is_pinned():
            raise AssertionError("the host tier's pages are not pinned")
        if hds.nbytes != table.nbytes or dds.nbytes != table.nbytes:
            raise AssertionError("the tiers hold another page layout")
        log(f"[tiers] put: host tier {hds.nbytes} B pinned in "
            f"{host_put_s:.3f} s, disk tier {dds.nbytes} B in "
            f"{len(os.listdir(spill))} spill file(s) in {disk_put_s:.3f} s "
            f"(set-up); budgets {TIER_BUDGET} B, default batch "
            f"{batch_pages} pages of {table.page_rows} rows = {batches} "
            f"batches")
        engines = {"host": ForestQueryEngine(host_store),
                   "disk": ForestQueryEngine(disk_store)}
        refs = {}
        for plan, algorithm, f in (("udf", "predicated_pallas_fused",
                                    forest),
                                   ("rel+reuse", "predicated_pallas", big)):
            r = engine.infer("higgs", f, plan=plan, algorithm=algorithm,
                             batch_pages=batch_pages)
            refs[plan] = r.predictions.cpu()
        torch.cuda.synchronize()

        def run(tier: str, plan: str, algorithm: str, f, depth: int,
                label: str):
            fused = algorithm.endswith("_fused")
            name_ = f"predicated_{'fused' if fused else 'raw'}"
            r, c = counted(lambda: engines[tier].infer(
                "higgs", f, plan=plan, algorithm=algorithm,
                prefetch_depth=depth))
            s = r.scan
            only(c, name_, r.n_parts * s.batches, f"[tiers] {label}")
            launches[name_] = launches.get(name_, 0) + c[name_]
            want = refs[plan]
            ok = (s.batches == batches and s.batch_pages == batch_pages
                  and s.max_in_flight == depth <= 2 and s.pinned_staging
                  and s.drain_async == (depth == 2)
                  and s.bytes_streamed == table.nbytes
                  and r.tier == tier and r.predictions.is_pinned()
                  and r.predictions.shape == want.shape
                  and torch.equal(bits(r.predictions), bits(want)))
            log(f"[tiers] run {label}: wall_s {s.wall_s:.6f}, "
                f"{HIGGS_ROWS / s.wall_s:.1f} rows/s; total_s "
                f"{r.total_s:.6f}, transfer_issue_s {s.transfer_issue_s:.6f}"
                f", transfer_wait_s {s.transfer_wait_s:.6f}, compute_s "
                f"{s.compute_s:.6f}, drain_s {s.drain_s:.6f}, drain_wait_s "
                f"{s.drain_wait_s:.6f}, drain_overlap_s "
                f"{s.drain_overlap_s:.6f}; {s.batches} batches of "
                f"{s.batch_pages} pages, max_in_flight {s.max_in_flight}, "
                f"bytes_streamed {s.bytes_streamed}, pinned_staging "
                f"{s.pinned_staging}, drain_async {s.drain_async}, "
                f"reuse_hit {r.reuse_hit}, {c[name_]} {name_} launches = "
                f"n_parts {r.n_parts} x {s.batches} batches, bit-identical "
                f"to the device tier: {'ok' if ok else 'FAIL'}; on {smi}")
            if not ok:
                raise AssertionError(f"[tiers] {label} failed its checks")
            return r

        waits = {}

        def udf_runs(tier: str) -> None:
            for i, depth in enumerate((2, 2, 1, 2, 1)):
                r = run(tier, "udf", "predicated_pallas_fused", forest,
                        depth, f"{tier} udf predicated_pallas_fused depth "
                        f"{depth} #{i}")
                if i:                       # #0 is the warm-up run
                    waits.setdefault((tier, depth), []).append(
                        r.scan.transfer_wait_s)
                del r

        udf_runs("host")
        src = torch.empty(LINK_BYTES // 4, dtype=torch.float32,
                          pin_memory=True)
        dst = torch.empty(LINK_BYTES // 4, dtype=torch.float32,
                          device="cuda")
        link_ms = cuda_ms(lambda: dst.copy_(src, non_blocking=True),
                          warmup=2, reps=10)
        link = LINK_BYTES / link_ms / 1e6
        del src, dst
        h2d_ms = table.nbytes / link / 1e6
        log(f"[tiers] link: one pinned {LINK_BYTES} B H2D copy_ "
            f"{link_ms:.4f} ms = {link:.3f} GB/s; the table's "
            f"{table.nbytes} B at that rate {h2d_ms:.4f} ms; scan bound "
            f"udf max(H2D, fused kernel {fused_ms:.4f} ms) = "
            f"{max(h2d_ms, fused_ms):.4f} ms, rel+reuse max(H2D, device-"
            f"tier query {1e3 * rel_device_s:.4f} ms) = "
            f"{max(h2d_ms, 1e3 * rel_device_s):.4f} ms; on {smi}")

        # A trace is complete when it holds one page copy per batch, as
        # long together as the table's bytes take at the link rate (within
        # PROFILE_H2D_SHARE: the scan's copies may run faster than the one
        # plain copy).  An incomplete trace is flagged: its busy share
        # misplaces the idle.  In this process the trace has missed page
        # copies in every run so far, before the disk-tier scans too;
        # chip_tiers_probe.py traces the query in a fresh process.
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            r = engines["host"].infer("higgs", forest, plan="udf",
                                      algorithm="predicated_pallas_fused")
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        del r
        _, _, h2d = device_intervals(prof)
        complete = (len(h2d) == batches and union_us(h2d) / 1e3
                    >= PROFILE_H2D_SHARE * h2d_ms)
        log(f"[tiers] profile host udf predicated_pallas_fused depth 2: "
            f"{scan_trace(prof, wall_us)}; trace complete: "
            f"{'yes' if complete else 'NO, the shares above miss copies'} "
            f"({len(h2d)} of {batches} copies, {union_us(h2d) / 1e3:.3f} of "
            f"the {h2d_ms:.4f} ms the table takes at the link rate); on "
            f"{smi}")

        udf_runs("disk")
        for tier in ("host", "disk"):
            w2 = sum(waits[tier, 2]) / 2
            w1 = sum(waits[tier, 1]) / 2
            log(f"[tiers] overlap_fraction {tier} udf: {1 - w2 / w1:.4f} "
                f"(= 1 - transfer_wait depth 2 / depth 1 = 1 - {w2:.6f} / "
                f"{w1:.6f}, means of runs #1-#4) on {smi}")
        rel = [run("host", "rel+reuse", "predicated_pallas", big, 2,
                   f"host rel+reuse predicated_pallas depth 2 #{i}")
               for i in range(2)]
        if rel[0].reuse_hit or not (rel[1].reuse_hit
                                    and rel[1].plan_reuse_hit) \
                or rel[1].partition_s != 0.0:
            raise AssertionError("[tiers] the repeated host-tier rel+reuse "
                                 "query did not hit both caches")
        log(f"[tiers] host rel+reuse repeat total_s {rel[1].total_s:.6f} "
            f"against the device tier's {rel_device_s:.6f} (phase 6, one "
            f"batch) on {smi}")
        del rel

        cut = store.get("higgs_1m").data[:CUT_ROWS]
        disk_store.put("cut", cut, tier="device")
        eng = engines["disk"]

        def cut_query():
            return eng.infer("cut", forest, plan="udf",
                             algorithm="predicated_pallas_fused",
                             batch_pages=MOVE_BATCH_PAGES)

        want, c = counted(cut_query)
        want = want.predictions.cpu()
        launches["predicated_fused"] += c["predicated_fused"]
        for tier in ("host", "disk", "device"):
            moved = disk_store.move("cut", tier)
            r, c = counted(cut_query)
            only(c, "predicated_fused", r.scan.batches,
                 f"[tiers] move to {tier}")
            launches["predicated_fused"] += c["predicated_fused"]
            ok = (moved.tier == r.tier == tier and r.plan_reuse_hit
                  and (tier != "host" or moved.data.is_pinned())
                  and torch.equal(bits(r.predictions.cpu()), bits(want)))
            files = sorted(os.listdir(spill))
            log(f"[tiers] move cut ({CUT_ROWS} rows) -> {tier}: "
                f"predictions unchanged, plan reused: "
                f"{'ok' if ok else 'FAIL'}; spill files {files}")
            if not ok:
                raise AssertionError(f"[tiers] move to {tier} changed the "
                                     f"query")
        if len(os.listdir(spill)) != 1:
            raise AssertionError("[tiers] moving off the disk tier left a "
                                 "spill file")
        disk_store.drop("higgs")
        host_store.drop("higgs")
        if os.listdir(spill):
            raise AssertionError("[tiers] drop left a spill file")
        log(f"[tiers] drop: spill directory empty; launches {launches}")
    finally:
        shutil.rmtree(spill, ignore_errors=True)
    return launches


def sparse_phase(*, counted, only, smi: str, tally) -> dict:
    """Phase 9: wide rows and the CSR plane.  The x-mode timings; Epsilon
    dense wide; Bosch as CSR against dense on the device, host and disk
    tiers; a Criteo-shaped CSR table.  ``tally(counts)`` adds a query's
    launches to the kernels' record.  Returns the wide-row kernels' record
    numbers at the Epsilon shape."""
    from repro_torch.core.forest import (compact_forest, make_forest,
                                         tree_slice)
    from repro_torch.core.postprocess import predict_proba
    from repro_torch.db.query import ForestQueryEngine
    from repro_torch.db.sparse import (concat_pages, csr_from_dense,
                                       densify_csr, paginate_csr)
    from repro_torch.db.store import TensorBlockStore
    from repro_torch.kernels.common import X_STAGED_MAX_F
    from repro_torch.kernels.forest_hummingbird import (
        hummingbird_fused_plain, hummingbird_raw_plain)
    from repro_torch.kernels.forest_predicated import (predicated_fused_plain,
                                                       predicated_raw_plain)
    from repro_torch.kernels.forest_quickscorer import (
        quickscorer_fused_plain, quickscorer_raw_plain)
    from repro_torch.kernels.gather import (csr_block_to_dense,
                                            gather_inverse_map)
    from repro_torch.kernels.ops import (KERNEL_WRAPPERS, RAW_KERNEL_WRAPPERS,
                                         prepare_inputs)

    plain = dict(predicated=predicated_fused_plain,
                 hummingbird=hummingbird_fused_plain,
                 quickscorer=quickscorer_fused_plain)
    raw_plain = dict(predicated=predicated_raw_plain,
                     hummingbird=hummingbird_raw_plain,
                     quickscorer=quickscorer_raw_plain)

    def forests(F: int, seed: int):
        """(500-tree, 1600-tree) random forests over F features."""
        fe, th, dl, lv = make_forest_arrays(np.random.default_rng(seed),
                                            integer_leaves=False, features=F)
        f = make_forest(fe, th, lv, default_left=dl, n_features=F,
                        device="cuda")
        fe, th, dl, lv = make_forest_arrays(
            np.random.default_rng(seed + 1), integer_leaves=False,
            trees=REL_TREES, leaf_scale=0.1 * math.sqrt(TREES / REL_TREES),
            features=F)
        big = make_forest(fe, th, lv, default_left=dl, n_features=F,
                          device="cuda")
        return f, big

    # -- x modes: each kernel staged and wide-row across widths ----------
    times: dict = {}
    for F in XMODE_F:
        x = card_rows(XMODE_ROWS, F, seed=SEED + 20)
        f, _ = forests(F, SEED + 21)
        part = tree_slice(f, 0, 16)
        for kind in KINDS:
            for fused in (True, False):
                variant = "fused" if fused else "raw"
                forest_ = f if fused else part
                wrapper = (KERNEL_WRAPPERS if fused
                           else RAW_KERNEL_WRAPPERS)[kind]
                got, tiles = {}, {}
                for staged in (True, False):
                    try:
                        args, tiles[staged] = prepare_inputs(
                            kind, forest_, x, fused=fused, staged=staged)
                    except ValueError:
                        got[staged] = None
                        continue
                    got[staged] = cuda_ms(
                        lambda: wrapper(*args, **tiles[staged]), warmup=1,
                        reps=3)
                times[kind, variant, F] = got
                bound_ms, bound_by, _ = bound(kind, XMODE_ROWS, F,
                                              forest_.num_trees,
                                              raw=not fused)
                st = ("does not fit" if got[True] is None
                      else f"{got[True]:.4f} ms")
                log(f"[sparse] xmode {kind} {variant} F={F}: staged {st}, "
                    f"wide {got[False]:.4f} ms ({XMODE_ROWS} rows x "
                    f"{forest_.num_trees} trees, tiles staged "
                    f"{tiles.get(True)} / wide {tiles[False]}); bound "
                    f"{bound_ms:.4f} ms by {bound_by}; on {smi}")
        del x
    for kind in KINDS:
        for variant in ("fused", "raw"):
            cross = next((F for F in XMODE_F
                          if times[kind, variant, F][True] is None
                          or times[kind, variant, F][False]
                          < times[kind, variant, F][True]), None)
            limit = X_STAGED_MAX_F[kind, variant == "fused"]
            log(f"[sparse] xmode crossover {kind} {variant}: the wide-row "
                f"mode is first faster at F={cross} of {XMODE_F}; the port "
                f"stages x up to "
                f"{'where a tile fits' if limit is None else limit}")

    def query(engine, dataset, f, plan, algorithm, label, *, n_rows,
              oracle=None, **kw):
        """One counted query: exact launches, finite predictions of the
        right shape, and (``oracle``) its first rows against the eager
        oracle."""
        kind = algorithm.split("_")[0]
        name = f"{kind}_{'fused' if algorithm.endswith('_fused') else 'raw'}"
        r, c = counted(lambda: engine.infer(dataset, f, plan=plan,
                                            algorithm=algorithm, **kw))
        s = r.scan
        only(c, name, r.n_parts * s.batches, f"[sparse] {label}")
        tally(c)
        preds = r.predictions
        if tuple(preds.shape) != (n_rows,) or not bool(
                torch.isfinite(preds).all()):
            raise AssertionError(f"[sparse] {label}: bad predictions")
        err = ""
        if oracle is not None:
            k = oracle.shape[0]
            got = preds[:k].to(oracle.device)
            e = float((got - oracle).abs().max())
            if not torch.allclose(got, oracle, rtol=TOL, atol=TOL):
                raise AssertionError(f"[sparse] {label}: {e} from the "
                                     f"eager oracle")
            err = f"; max |pred - eager predicated| over {k} rows = {e!r}"
        log(f"[sparse] run {label}: wall_s {s.wall_s:.6f}, "
            f"{n_rows / s.wall_s:.1f} rows/s; total_s {r.total_s:.6f}, "
            f"storage_format {r.storage_format}, tier {r.tier}, n_parts "
            f"{r.n_parts} x {s.batches} batches of {s.batch_pages} pages = "
            f"{c[name]} {name} launches ({c[name + '_wide']} wide-row), "
            f"reuse_hit {r.reuse_hit}, bytes_streamed {s.bytes_streamed}, "
            f"transfer_wait_s {s.transfer_wait_s:.6f}, compute_s "
            f"{s.compute_s:.6f}; stages {stage_sums(r)}{err}; on {smi}")
        return r

    # -- Epsilon: dense, 2,000 features, device tier ---------------------
    t0 = time.perf_counter()
    store = TensorBlockStore(device="cuda")
    x = card_rows(EPSILON_ROWS, EPSILON_F, seed=SEED + 30)
    eps = store.put("epsilon", x)
    del x
    f, big = forests(EPSILON_F, SEED + 31)
    sample = eps.data[:COMPARE_ROWS]
    oracle = predict_proba(f, sample, algorithm="predicated")
    big_oracle = predict_proba(big, sample, algorithm="predicated")
    torch.cuda.synchronize()
    log(f"[sparse] epsilon: {EPSILON_ROWS} x {EPSILON_F} f32 dense, "
        f"{eps.nbytes} B on the device tier, {time.perf_counter() - t0:.3f} "
        f"s set-up")
    engine = ForestQueryEngine(store)
    for algorithm in ("predicated_pallas_fused", "hummingbird_pallas_fused",
                      "quickscorer_pallas_fused"):
        query(engine, "epsilon", f, "udf", algorithm,
              f"epsilon udf {algorithm}", n_rows=EPSILON_ROWS,
              oracle=oracle)
    rel = [query(engine, "epsilon", big, "rel+reuse", "predicated_pallas",
                 f"epsilon rel+reuse predicated_pallas #{i}",
                 n_rows=EPSILON_ROWS, oracle=big_oracle) for i in range(2)]
    if rel[0].reuse_hit or not (rel[1].reuse_hit and rel[1].plan_reuse_hit):
        raise AssertionError("[sparse] the repeated Epsilon rel+reuse query "
                             "did not hit both caches")
    for algorithm in ("hummingbird_pallas", "quickscorer_pallas"):
        query(engine, "epsilon", big, "rel+reuse", algorithm,
              f"epsilon rel+reuse {algorithm}", n_rows=EPSILON_ROWS,
              oracle=big_oracle)
    # the wide-row kernels' record numbers, at the Epsilon shape
    record = {}
    part = tree_slice(big, 0, 16)
    for kind in KINDS:
        for fused in (True, False):
            variant = "fused" if fused else "raw"
            args, tiles = prepare_inputs(kind, f if fused else part,
                                         eps.data, fused=fused)
            wrapper = (KERNEL_WRAPPERS if fused
                       else RAW_KERNEL_WRAPPERS)[kind]
            ms = cuda_ms(lambda: wrapper(*args, **tiles), warmup=1, reps=3)
            got = wrapper(*args, **tiles)
            want, plain_ms = timed_plain((plain if fused
                                          else raw_plain)[kind], args,
                                         DEPTH)
            err = float((got - want).abs().max())
            ok = (torch.allclose(got, want, rtol=TOL, atol=TOL) if fused
                  else torch.equal(bits(got), bits(want)))
            B, T = eps.data.shape[0], args[1].shape[0]
            bound_ms, bound_by, parts = bound(kind, B, EPSILON_F, T,
                                              raw=not fused)
            log(f"[sparse] timing {kind} {variant} wide-row x: {B} rows x "
                f"{EPSILON_F} features x {T} trees, tiles {tiles}: kernel "
                f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                f"{bound_ms:.4f} ms by {bound_by} ({parts}), max_abs_err "
                f"{err!r}: {'ok' if ok else 'FAIL'}; on {smi}")
            if not ok or tiles["staged"]:
                raise AssertionError(f"[sparse] {kind} {variant} at the "
                                     f"Epsilon shape")
            record[f"{kind}_{variant}_wide"] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by)
            del args, got, want
    store.drop("epsilon")
    del eps, sample, oracle, big_oracle, engine, store, rel

    # -- Bosch: CSR against dense, device / host / disk tiers --------------
    t0 = time.perf_counter()
    x = card_rows(BOSCH_ROWS, BOSCH_F, seed=SEED + 40, missing=BOSCH_MISSING)
    f, big = forests(BOSCH_F, SEED + 41)
    dev_store = TensorBlockStore(device="cuda")
    dense = dev_store.put("dense", x)
    csr = dev_store.put_sparse("csr", x)
    oracle = predict_proba(f, x[:COMPARE_ROWS], algorithm="predicated")
    del x
    torch.cuda.synchronize()
    f_used = compact_forest(f)[1].numel()
    log(f"[sparse] bosch: {BOSCH_ROWS} x {BOSCH_F}, {BOSCH_MISSING:.0%} "
        f"missing: dense {dense.nbytes} B, CSR {csr.nbytes} B "
        f"({csr.nbytes / dense.nbytes:.4f} of dense; {csr.nnz} entries, "
        f"capacity {csr.pages.capacity} a page of {csr.page_rows} rows); "
        f"F_used {f_used} (500 trees), "
        f"{compact_forest(big)[1].numel()} (1600); "
        f"{time.perf_counter() - t0:.3f} s set-up")
    runs = (("udf", "predicated_pallas_fused", f),
            ("udf", "hummingbird_pallas_fused", f),
            ("rel+reuse", "predicated_pallas", big),
            ("rel+reuse", "predicated_pallas", big))

    def bosch(engine, dataset: str, tier: str, fmt: str, want=None):
        out = []
        for i, (plan, algorithm, forest_) in enumerate(runs):
            r = query(engine, dataset, forest_, plan, algorithm,
                      f"bosch {tier} {fmt} {plan} {algorithm} #{i}",
                      n_rows=BOSCH_ROWS,
                      oracle=oracle if i == 0 and want is None else None)
            if (r.storage_format, r.tier) != (fmt, tier):
                raise AssertionError(f"[sparse] bosch ran {r.storage_format}"
                                     f" on {r.tier}")
            if i == 3 and not (r.reuse_hit and r.plan_reuse_hit):
                raise AssertionError("[sparse] the repeated rel+reuse query "
                                     "missed a cache")
            preds = r.predictions.cpu()
            if want is not None and not torch.equal(bits(preds),
                                                    bits(want[i])):
                raise AssertionError(f"[sparse] bosch {tier} {fmt} "
                                     f"{algorithm} differs from the device "
                                     f"tier's dense predictions")
            out.append(preds)
        return out

    engine = ForestQueryEngine(dev_store)
    want = bosch(engine, "dense", "device", "dense")
    bosch(engine, "csr", "device", "csr", want)
    log("[sparse] bosch device tier: CSR == dense bit for bit, every query")
    spill = tempfile.mkdtemp(prefix="chip-smoke-sparse-")
    try:
        host_store = TensorBlockStore(device="cuda",
                                      device_budget_bytes=TIER_BUDGET)
        host_engine = ForestQueryEngine(host_store)
        for fmt in ("dense", "csr"):
            t0 = time.perf_counter()
            if fmt == "dense":
                ds = host_store.put("dense", dense.data[:BOSCH_ROWS])
            else:
                ds = host_store.put_sparse("csr", pages=csr.pages,
                                           num_rows=BOSCH_ROWS)
            if ds.tier != "host":
                raise AssertionError(f"[sparse] the auto cascade put {fmt} "
                                     f"on {ds.tier}")
            log(f"[sparse] bosch host tier {fmt}: {ds.nbytes} B pinned in "
                f"{time.perf_counter() - t0:.3f} s (set-up); "
                f"{pinned_bytes()}")
            bosch(host_engine, fmt, "host", fmt, want)
            # where a streamed scan's time goes: the kernel, the gather's
            # torch ops, the page copies (a copy stream beside the kernels,
            # so the busy share is the union of the device intervals)
            prof, wall_us = traced(lambda: host_engine.infer(
                fmt, f, plan="udf", algorithm="predicated_pallas_fused"))
            log(f"[profile] bosch host-tier {fmt} udf "
                f"predicated_pallas_fused: {scan_trace(prof, wall_us)}; on "
                f"{smi}")
            log_device_time(prof, top=10)
            del prof
            host_store.drop(fmt)
            del ds
            gc.collect()
        log("[sparse] bosch host tier: CSR == dense == the device tier, "
            "bit for bit")
        disk_store = TensorBlockStore(device="cuda",
                                      device_budget_bytes=TIER_BUDGET,
                                      host_budget_bytes=TIER_BUDGET,
                                      spill_dir=spill)
        t0 = time.perf_counter()
        ds = disk_store.put_sparse("csr", pages=csr.pages,
                                   num_rows=BOSCH_ROWS)
        log(f"[sparse] bosch disk tier csr: {ds.nbytes} B in "
            f"{sorted(os.listdir(spill))} in {time.perf_counter() - t0:.3f} "
            f"s (set-up)")
        if ds.tier != "disk" or len(os.listdir(spill)) != 3:
            raise AssertionError("[sparse] the CSR table is not three spill "
                                 "files on the disk tier")
        bosch(ForestQueryEngine(disk_store), "csr", "disk", "csr", want)
        disk_store.drop("csr")
        if os.listdir(spill):
            raise AssertionError("[sparse] drop left a spill file")
        log("[sparse] bosch disk tier: CSR == the device tier's dense, bit "
            "for bit; spill files removed")
    finally:
        shutil.rmtree(spill, ignore_errors=True)
    del ds, dense, csr, want, oracle, engine, dev_store, host_store
    gc.collect()
    torch.cuda.empty_cache()

    # -- Criteo-shaped: CSR only, 2M x 10,000 at 96 % missing ----------------
    t0 = time.perf_counter()
    chunk = CRITEO_BATCH_PAGES * PAGE_ROWS
    gen_seed = SEED + 50
    blocks = []
    for lo in range(0, CRITEO_ROWS, chunk):
        n = min(chunk, CRITEO_ROWS - lo)
        x = card_rows(n, CRITEO_F, seed=gen_seed + lo // chunk,
                      missing=CRITEO_MISSING)
        blocks.append(paginate_csr(*csr_from_dense(x), num_rows=n,
                                   page_rows=PAGE_ROWS, n_features=CRITEO_F))
        del x
    pages = concat_pages(blocks, n_features=CRITEO_F)
    del blocks
    store = TensorBlockStore(device="cuda")
    ds = store.put_sparse("criteo", pages=pages, num_rows=CRITEO_ROWS)
    if ds.pages.indices is not pages.indices:
        raise AssertionError("[sparse] a device-tier pages= handoff copied")
    f, _ = forests(CRITEO_F, SEED + 51)
    torch.cuda.synchronize()
    gather_idx = compact_forest(f)[1]
    log(f"[sparse] criteo: {CRITEO_ROWS} x {CRITEO_F}, {CRITEO_MISSING:.0%} "
        f"missing, made on the card in {chunk}-row chunks: CSR {ds.nbytes} B "
        f"on the device tier ({ds.nnz} entries, capacity "
        f"{ds.pages.capacity}; dense would be {CRITEO_ROWS * CRITEO_F * 4} "
        f"B); F_used {gather_idx.numel()}; "
        f"{time.perf_counter() - t0:.3f} s set-up")
    engine = ForestQueryEngine(store)
    inv = gather_inverse_map(gather_idx, CRITEO_F, device="cuda")
    block = ds.page_slice(0, CRITEO_BATCH_PAGES)
    gather_ms = cuda_ms(lambda: csr_block_to_dense(block, inv,
                                                   gather_idx.numel()),
                        warmup=1, reps=3)
    head = {}
    for algorithm in ("predicated_pallas_fused", "hummingbird_pallas_fused"):
        r = query(engine, "criteo", f, "udf", algorithm,
                  f"criteo csr udf {algorithm}", n_rows=CRITEO_ROWS,
                  batch_pages=CRITEO_BATCH_PAGES)
        if r.storage_format != "csr":
            raise AssertionError("[sparse] criteo did not run the CSR plane")
        stage_s = sum(x.seconds for x in r.stage_reports)
        share = r.scan.batches * gather_ms / 1e3 / stage_s
        log(f"[sparse] criteo udf {algorithm}: {CRITEO_ROWS / r.total_s:.1f}"
            f" rows/s (total_s {r.total_s:.6f}); the gather of one "
            f"{CRITEO_BATCH_PAGES}-page block {gather_ms:.4f} ms (CUDA "
            f"events), x {r.scan.batches} batches = {share:.4f} of the "
            f"stage time {stage_s:.6f} s; on {smi}")
        head[algorithm] = r.predictions[:chunk].clone()
        del r
    dense_head = densify_csr(*block.tensors(), CRITEO_F)
    dstore = TensorBlockStore(device="cuda")
    dstore.put("criteo_head", dense_head)
    del dense_head
    dengine = ForestQueryEngine(dstore)
    for algorithm, want in head.items():
        r = query(dengine, "criteo_head", f, "udf", algorithm,
                  f"criteo dense head udf {algorithm}", n_rows=chunk)
        if not torch.equal(bits(r.predictions), bits(want)):
            raise AssertionError(f"[sparse] criteo {algorithm}: CSR and the "
                                 f"densified head differ")
        log(f"[sparse] criteo {algorithm}: CSR == the dense plane (F="
            f"{CRITEO_F}, full forest) on the first {chunk} rows, bit for "
            f"bit")
    store.drop("criteo")
    dstore.drop("criteo_head")
    return record


def register_report(text: str) -> dict[bool, set]:
    """ptxas's register lines of one library, split by the kernels' node
    record: {False: the f32 instantiations', True: the bf16 ones'} (the
    record is the last template argument, ``NARROW``)."""
    import re

    out: dict[bool, set] = {False: set(), True: set()}
    narrow = None
    for ln in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            narrow = re.search(r"ELb[01]ELb[01]ELb1EE", m.group(1)) is not None
        elif "registers" in ln and narrow is not None:
            out[narrow].add(ln.split(":", 1)[1].strip())
            narrow = None
    return out


def timing_line(t) -> str:
    return (f"parse_s {t.parse_s:.6f}, convert_s {t.convert_s:.6f}, "
            f"transfer_s {t.transfer_s:.6f}, total_s {t.total_s:.6f}")


def host_s(fn):
    """``fn()`` timed on the host clock, ending in a device synchronise:
    (its result, seconds)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def load_phase(*, counted, only, smi: str, tally) -> None:
    """Phase 10: the paper's external load (parse, convert, transfer, then
    inference over the loaded tensor) against in-database inference over
    the same rows already in the store.  ``tally(counts)`` adds each
    query's launches to the kernels' record."""
    from repro_torch.core.forest import make_forest
    from repro_torch.core.postprocess import postprocess
    from repro_torch.db import loader as ld
    from repro_torch.db.query import ForestQueryEngine
    from repro_torch.db.store import TensorBlockStore
    from repro_torch.kernels.ops import predicated_pallas_fused

    def forest_over(F: int, trees: int, seed: int):
        fe, th, dl, lv = make_forest_arrays(np.random.default_rng(seed),
                                            integer_leaves=False,
                                            trees=trees, features=F)
        return make_forest(fe, th, lv, default_left=dl, n_features=F,
                           model_type="xgboost", task="classification",
                           device="cuda")

    def written(path: str, what: str, t0: float) -> None:
        log(f"[load] set-up: {what} written to {os.path.basename(path)}, "
            f"{os.path.getsize(path)} B, in {time.perf_counter() - t0:.3f} "
            f"s (untimed)")

    def loaded(name: str, t, nbytes: int) -> None:
        rate = (f", {nbytes / t.transfer_s / 1e9:.2f} GB/s"
                if t.transfer_s else "")
        log(f"[load] {name} LoadTiming {timing_line(t)} ({nbytes} B "
            f"on the tier{rate}); on {smi}")

    def udf(engine, dataset, forest, algorithm, label, n_rows, **kw):
        """One counted in-database query: exact launches, finite
        predictions of the right shape."""
        kind = algorithm.split("_")[0]
        r, c = counted(lambda: engine.infer(dataset, forest, plan="udf",
                                            algorithm=algorithm, **kw))
        only(c, f"{kind}_fused", r.scan.batches, f"[load] {label}")
        tally(c)
        if tuple(r.predictions.shape) != (n_rows,) or not bool(
                torch.isfinite(r.predictions).all()):
            raise AssertionError(f"[load] {label}: bad predictions")
        log(f"[load] run {label}: total_s {r.total_s:.6f}, tier {r.tier}, "
            f"storage_format {r.storage_format}, {r.scan.batches} batches "
            f"= {c[f'{kind}_fused']} {kind}_fused launches "
            f"({c[f'{kind}_fused_wide']} wide-row), plan_reuse_hit "
            f"{r.plan_reuse_hit}; stages {stage_sums(r)}; on {smi}")
        return r

    def external_against_in_database(what, rows, t_load, forest, engine,
                                     dataset):
        """The fused predicated kernel + postprocess over the loaded rows
        against the in-database udf query over the same rows: both
        breakdowns, the ratio, the predictions bit for bit."""
        def external():
            sums = predicated_pallas_fused(forest, rows)
            return postprocess(sums, model_type=forest.model_type,
                               task=forest.task, num_trees=forest.num_trees,
                               base_score=forest.base_score)

        external()          # builds the forest's kernel trees, kept after
        (ext, infer_s), c = counted(lambda: host_s(external))
        only(c, "predicated_fused", 1, f"[load] {what} external inference")
        tally(c)
        n = rows.shape[0]
        label = f"{what} in-database udf predicated_pallas_fused"
        first = udf(engine, dataset, forest, "predicated_pallas_fused",
                    f"{label} #0", n)
        repeat = udf(engine, dataset, forest, "predicated_pallas_fused",
                     f"{label} #1", n)
        if not torch.equal(bits(ext), bits(repeat.predictions)):
            raise AssertionError(f"[load] {what}: the external and the "
                                 f"in-database predictions differ")
        ext_s = t_load.total_s + infer_s
        log(f"[load] ratio {what}: external {ext_s:.6f} s (load "
            f"{t_load.total_s:.6f}: {timing_line(t_load)}; inference "
            f"{infer_s:.6f}) / in-database {repeat.total_s:.6f} s (repeat; "
            f"first {first.total_s:.6f}) = {ext_s / repeat.total_s:.1f}; "
            f"predictions bit-identical over {n} rows; on {smi}")

    tmp = tempfile.mkdtemp(prefix="chip-smoke-load-")
    try:
        # -- HIGGS as CSV, at the small and the large model ------------------
        t0 = time.perf_counter()
        x = card_rows(LOAD_HIGGS_ROWS, FEATURES, seed=SEED + 60).cpu().numpy()
        csv = os.path.join(tmp, "higgs.csv")
        ld.write_csv(csv, x)
        written(csv, f"HIGGS {LOAD_HIGGS_ROWS} x {FEATURES} as CSV", t0)
        del x
        rows, t_csv = ld.load_csv_external(csv, device="cuda")
        loaded("load_csv_external higgs", t_csv, rows.nbytes)
        if not (rows.is_cuda and tuple(rows.shape)
                == (LOAD_HIGGS_ROWS, FEATURES)):
            raise AssertionError("[load] the CSV did not land on the card")
        store = TensorBlockStore(device="cuda")
        store.put("higgs_csv", rows)
        engine = ForestQueryEngine(store)
        for trees in LOAD_TREES:
            external_against_in_database(
                f"higgs {trees} trees", rows, t_csv,
                forest_over(FEATURES, trees, SEED + 61 + trees), engine,
                "higgs_csv")
        store.drop("higgs_csv")
        del rows

        # -- Criteo-shaped LIBSVM onto every tier -----------------------------
        t0 = time.perf_counter()
        n, F = LOAD_CRITEO_ROWS, CRITEO_F
        x = card_rows(n, F, seed=SEED + 62, missing=CRITEO_MISSING)
        y = (torch.rand(n, generator=torch.Generator().manual_seed(SEED))
             < 0.5).float().numpy()
        svm = os.path.join(tmp, "criteo.svm")
        ld.write_libsvm(svm, x.cpu().numpy(), y)
        written(svm, f"Criteo-shaped {n} x {F} at {CRITEO_MISSING:.0%} "
                f"missing as LIBSVM ({int(torch.isfinite(x).sum())} "
                f"entries)", t0)
        del x
        dense, labels, t_dense = ld.load_libsvm_external(svm, F,
                                                         device="cuda")
        loaded("load_libsvm_external criteo (dense fallback)", t_dense,
               dense.nbytes)
        if not np.array_equal(labels, y):
            raise AssertionError("[load] the LIBSVM labels differ")
        forest = forest_over(F, TREES, SEED + 63)
        want = {}
        # the same rows, put_sparse(data=) on the device tier
        store.put_sparse("criteo_rows", data=dense, tier="device")
        for algorithm in ("predicated_pallas_fused",
                          "hummingbird_pallas_fused"):
            for i in range(2):      # the repeat is the in-database time
                want[algorithm] = udf(
                    engine, "criteo_rows", forest, algorithm,
                    f"criteo put_sparse(data=) device udf {algorithm} #{i}",
                    n, batch_pages=LOAD_CRITEO_BATCH_PAGES)
        del dense
        store.drop("criteo_rows")
        for tier in ("device", "host", "disk"):
            pages, labels, t = ld.load_libsvm_csr_external(
                svm, F, page_rows=PAGE_ROWS, tier=tier, spill_dir=tmp,
                device="cuda")
            loaded(f"load_libsvm_csr_external criteo tier={tier}", t,
                   pages.nbytes)
            ds = store.put_sparse(f"criteo_{tier}", pages=pages,
                                  num_rows=n, labels=labels, tier=tier)
            handed = all(a is b for a, b in zip(ds.pages.arrays(),
                                                pages.arrays()))
            where = dict(device=lambda a: a.is_cuda,
                         host=lambda a: a.is_pinned(),
                         disk=lambda a: isinstance(a, np.memmap))[tier]
            if not (handed and all(map(where, pages.arrays()))
                    and ds.tier == tier) or (
                    tier != "device" and t.transfer_s != 0.0):
                raise AssertionError(f"[load] the {tier}-tier load was not "
                                     f"handed over zero-copy")
            names = sorted(os.path.basename(a.filename)
                           for a in pages.arrays()) if tier == "disk" else ""
            log(f"[load] criteo tier={tier}: put_sparse(pages=) zero-copy "
                f"(every array 'is' the loader's), transfer_s "
                f"{t.transfer_s!r} {names}")
            for algorithm, ref in want.items():
                r = udf(engine, f"criteo_{tier}", forest, algorithm,
                        f"criteo {tier} csr udf {algorithm}", n,
                        batch_pages=LOAD_CRITEO_BATCH_PAGES)
                if not torch.equal(bits(r.predictions.cpu()),
                                   bits(ref.predictions.cpu())):
                    raise AssertionError(f"[load] criteo {tier} "
                                         f"{algorithm}: not put_sparse("
                                         f"data=)'s predictions")
                log(f"[load] ratio criteo {tier} {algorithm}: external "
                    f"{t.total_s + r.total_s:.6f} s (load {t.total_s:.6f} "
                    f"+ query {r.total_s:.6f}) / in-database "
                    f"{ref.total_s:.6f} s = "
                    f"{(t.total_s + r.total_s) / ref.total_s:.1f}; "
                    f"predictions bit for bit put_sparse(data=)'s")
            store.drop(f"criteo_{tier}")
            del ds, pages
            gc.collect()

        # -- Epsilon as array rows ------------------------------------------
        t0 = time.perf_counter()
        x = card_rows(LOAD_EPSILON_ROWS, EPSILON_F,
                      seed=SEED + 64).cpu().numpy()
        arr = os.path.join(tmp, "epsilon.arr")
        ld.write_array_rows(arr, x)
        written(arr, f"Epsilon {LOAD_EPSILON_ROWS} x {EPSILON_F} as array "
                f"rows", t0)
        del x
        rows, t_arr = ld.load_array_rows_external(arr, device="cuda")
        loaded("load_array_rows_external epsilon", t_arr, rows.nbytes)
        store.put("epsilon_arr", rows)
        external_against_in_database(
            f"epsilon {TREES} trees", rows, t_arr,
            forest_over(EPSILON_F, TREES, SEED + 65), engine, "epsilon_arr")
        store.drop("epsilon_arr")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    from repro_torch.core.forest import make_forest, tree_slice
    from repro_torch.core.postprocess import predict_proba
    from repro_torch.db.query import ForestQueryEngine
    from repro_torch.db.store import TensorBlockStore
    from repro_torch.kernels import _build
    from repro_torch.kernels.forest_hummingbird import (
        hummingbird_fused_plain, hummingbird_raw_plain)
    from repro_torch.kernels.forest_predicated import (predicated_fused_plain,
                                                       predicated_raw_plain)
    from repro_torch.kernels.forest_quickscorer import (
        quickscorer_fused_plain, quickscorer_raw_plain)
    from repro_torch.kernels.ops import (KERNEL_WRAPPERS, RAW_KERNEL_WRAPPERS,
                                         default_tree_block,
                                         predict_sum_pallas, prepare_inputs)

    BF16 = torch.bfloat16
    plain = dict(predicated=predicated_fused_plain,
                 hummingbird=hummingbird_fused_plain,
                 quickscorer=quickscorer_fused_plain)
    raw_plain = dict(predicated=predicated_raw_plain,
                     hummingbird=hummingbird_raw_plain,
                     quickscorer=quickscorer_raw_plain)
    wrappers = {**{f"{k}_fused": w for k, w in KERNEL_WRAPPERS.items()},
                **{f"{k}_raw": w for k, w in RAW_KERNEL_WRAPPERS.items()}}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def counted(run):
        """Run ``run()`` with every kernel's launch counts set to 0 just
        before; return its result and the counts just after: each
        wrapper's launches under its name, those in the wide-row x mode
        also under ``<name>_wide``, a fused kernel's over bf16 tree tiles
        also under ``<name>_bf16``."""
        for w in wrappers.values():
            w.launches = w.wide_launches = 0
        for w in KERNEL_WRAPPERS.values():
            w.bf16_launches = 0
        out = run()
        torch.cuda.synchronize()
        counts = {name: w.launches for name, w in wrappers.items()}
        counts.update({f"{name}_wide": w.wide_launches
                       for name, w in wrappers.items()})
        counts.update({f"{kind}_fused_bf16": w.bf16_launches
                       for kind, w in KERNEL_WRAPPERS.items()})
        return out, counts

    def only(counts: dict, name: str, want: int, what: str) -> None:
        if counts[name] != want or want == 0:
            raise AssertionError(f"{what}: {counts[name]} {name} launches, "
                                 f"expected {want}")
        stray = {k: n for k, n in counts.items()
                 if k not in (name, f"{name}_wide", f"{name}_bf16") and n}
        if stray:
            raise AssertionError(f"{what}: other kernels launched {stray}")

    # -- 1. report ----------------------------------------------------------
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi_line()
    log(f"[report] device={name} count={count} nvidia-smi: {smi}")

    # -- 2. build -----------------------------------------------------------
    build_s = _build.build_all()
    log(f"[build] nvcc sm_90a, {len(_build.KERNEL_SOURCES)} libraries in "
        f"{build_s:.3f} s")
    for lib, text in _build.BUILD_LOG.items():
        regs = register_report(text)
        log(f"[build] {lib}: {'; '.join(sorted(regs[False]))}")
        log(f"[build] {lib} bf16: {'; '.join(sorted(regs[True]))}")

    # -- 3. kernel against plain version ------------------------------------
    rng = np.random.default_rng(SEED)
    x_np = rng.normal(size=(CHECK_ROWS, FEATURES)).astype(np.float32)
    x_np[rng.random(x_np.shape) < 0.05] = np.nan
    x_np[::16] = np.nan                                  # whole NaN rows
    x_chk = torch.from_numpy(x_np).cuda()
    max_err = {k: 0.0 for k in KINDS}
    raw_err = {k: 0.0 for k in KINDS}
    for integer in (True, False):
        fe, th, dl, lv = make_forest_arrays(np.random.default_rng(SEED + 1),
                                            integer_leaves=integer)
        f = make_forest(fe, th, lv, default_left=dl, n_features=FEATURES,
                        device="cuda")
        for kind in KINDS:
            args, tiles = prepare_inputs(kind, f, x_chk)
            got = KERNEL_WRAPPERS[kind](*args, **tiles)
            torch.cuda.synchronize()
            want = plain[kind](*args, depth=DEPTH)
            err = float((got - want).abs().max())
            if integer:
                ok = torch.equal(got, want)
                what = "bit-identical"
            else:
                ok = torch.allclose(got, want, rtol=TOL, atol=TOL)
                what = f"rtol=atol={TOL}"
                max_err[kind] = max(max_err[kind], err)
            log(f"[kernels] {kind} {'integer' if integer else 'float'} "
                f"leaves, {CHECK_ROWS} rows (1/16 all-NaN): max_abs_err="
                f"{err!r} {what}: {'ok' if ok else 'FAIL'}")
            if not ok or not bool(torch.isfinite(got).all()):
                raise AssertionError(f"{kind} kernel disagrees with its "
                                     f"plain version")
            args, tiles = prepare_inputs(kind, f, x_chk, fused=False)
            got = RAW_KERNEL_WRAPPERS[kind](*args, **tiles)
            torch.cuda.synchronize()
            want = raw_plain[kind](*args, depth=DEPTH)
            err = float((got - want).abs().max())
            raw_err[kind] = max(raw_err[kind], err)
            ok = torch.equal(bits(got), bits(want)) and bool(
                torch.isfinite(got).all())
            log(f"[kernels] {kind} raw {'integer' if integer else 'float'} "
                f"leaves, {CHECK_ROWS} rows x {TREES} trees, tiles {tiles}: "
                f"max_abs_err={err!r} bit-identical: "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{kind} raw kernel disagrees with its "
                                     f"plain version")

    # every kernel at the shallower depths, -0.0 leaves (a leaf lookup
    # keeps the sign; HummingBird's contraction gives +0.0)
    for depth in sorted(set().union(*SHALLOW.values())):
        fe, th, dl, lv = make_forest_arrays(
            np.random.default_rng(SEED + 10 + depth), integer_leaves=True,
            trees=37, depth=depth)
        lv[:, ::3] = -0.0
        f = make_forest(fe, th, lv, default_left=dl, n_features=FEATURES,
                        device="cuda")
        for kind in (k for k in KINDS if depth in SHALLOW[k]):
            for fused in (True, False):
                args, tiles = prepare_inputs(kind, f, x_chk, fused=fused)
                wrapper = (KERNEL_WRAPPERS if fused
                           else RAW_KERNEL_WRAPPERS)[kind]
                got = wrapper(*args, **tiles)
                torch.cuda.synchronize()
                want = (plain if fused else raw_plain)[kind](*args,
                                                             depth=depth)
                ok = torch.equal(bits(got), bits(want))
                err = float((got - want).abs().max())
                (max_err if fused else raw_err)[kind] = max(
                    (max_err if fused else raw_err)[kind], err)
                log(f"[kernels] {kind} {'fused' if fused else 'raw'} depth "
                    f"{depth}, 37 trees, integer and -0.0 leaves, "
                    f"{CHECK_ROWS} rows, tiles {tiles}: max_abs_err={err!r} "
                    f"bit for bit: {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"{kind} at depth {depth} disagrees "
                                         f"with its plain version")

    # bf16 tree tiles: the fused kernels over narrow node records (8-byte
    # ones past 32,768 features), bit for bit against their plain versions
    bf16_err = {k: 0.0 for k in KINDS}

    def hold_bf16(kind, f, x, depth, what, staged=None):
        try:
            args, tiles = prepare_inputs(kind, f, x, staged=staged,
                                         tree_dtype=BF16)
        except ValueError:
            log(f"[kernels] {kind}_fused_bf16 {what}, staged: does not fit "
                f"one block")
            return
        got = KERNEL_WRAPPERS[kind](*args, **tiles)
        torch.cuda.synchronize()
        want = plain[kind](*args, depth=depth)
        ok = torch.equal(bits(got), bits(want)) and bool(
            torch.isfinite(got).all())
        err = float((got - want).abs().max())
        bf16_err[kind] = max(bf16_err[kind], err)
        log(f"[kernels] {kind}_fused_bf16 {what}, "
            f"{4 if args[1].dim() == 2 else 8}-byte node records, "
            f"{'staged' if tiles['staged'] else 'wide-row'} x, tiles "
            f"{tiles}: max_abs_err={err!r} bit for bit: "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{kind} over bf16 tree tiles, {what}, "
                                 f"disagrees with its plain version")

    for integer in (True, False):
        fe, th, dl, lv = make_forest_arrays(np.random.default_rng(SEED + 1),
                                            integer_leaves=integer)
        f = make_forest(fe, th, lv, default_left=dl, n_features=FEATURES,
                        device="cuda")
        for kind in KINDS:
            hold_bf16(kind, f, x_chk, DEPTH,
                      f"{'integer' if integer else 'float'} leaves, depth "
                      f"{DEPTH}, {TREES} trees, {CHECK_ROWS} rows (1/16 "
                      f"all-NaN)")
    for depth in sorted(set().union(*SHALLOW.values())):
        fe, th, dl, lv = make_forest_arrays(
            np.random.default_rng(SEED + 10 + depth), integer_leaves=True,
            trees=37, depth=depth)
        lv[:, ::3] = -0.0
        f = make_forest(fe, th, lv, default_left=dl, n_features=FEATURES,
                        device="cuda")
        for kind in (k for k in KINDS if depth in SHALLOW[k]):
            hold_bf16(kind, f, x_chk, depth,
                      f"depth {depth}, 37 trees, integer and -0.0 leaves, "
                      f"{CHECK_ROWS} rows")
    del x_chk

    # wide rows: every kernel, fused and raw, in the wide-row x mode and,
    # where a 32-sample x tile fits, staged, at depth 8 with integer
    # leaves; then the shallower depths with -0.0 leaves, wide mode
    wide_err = {f"{k}_{v}_wide": 0.0 for k in KINDS for v in ("fused", "raw")}

    def hold_wide(kind, f, x, fused, staged, depth, what):
        try:
            args, tiles = prepare_inputs(kind, f, x, fused=fused,
                                         staged=staged)
        except ValueError:
            log(f"[kernels] {kind} {'fused' if fused else 'raw'} {what}, "
                f"staged: does not fit one block")
            return
        wrapper = (KERNEL_WRAPPERS if fused else RAW_KERNEL_WRAPPERS)[kind]
        got = wrapper(*args, **tiles)
        torch.cuda.synchronize()
        want = (plain if fused else raw_plain)[kind](*args, depth=depth)
        ok = torch.equal(bits(got), bits(want))
        err = float((got - want).abs().max())
        variant = "fused" if fused else "raw"
        if staged:
            (max_err if fused else raw_err)[kind] = max(
                (max_err if fused else raw_err)[kind], err)
        else:
            wide_err[f"{kind}_{variant}_wide"] = max(
                wide_err[f"{kind}_{variant}_wide"], err)
        log(f"[kernels] {kind} {variant} {what}, "
            f"{'staged' if staged else 'wide-row'} x, tiles {tiles}: "
            f"max_abs_err={err!r} bit for bit: {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{kind} {variant} {what} disagrees with "
                                 f"its plain version")

    for F in WIDE_CHECK_F:
        x_wide = card_rows(CHECK_ROWS, F, seed=SEED + 4, missing=0.05,
                           nan_every=16)
        fe, th, dl, lv = make_forest_arrays(
            np.random.default_rng(SEED + 5), integer_leaves=True,
            features=F)
        f = make_forest(fe, th, lv, default_left=dl, n_features=F,
                        device="cuda")
        for kind in KINDS:
            for fused in (True, False):
                for staged in (False, True):
                    hold_wide(kind, f, x_wide, fused, staged, DEPTH,
                              f"F={F}, depth {DEPTH}, {TREES} trees, "
                              f"integer leaves, {CHECK_ROWS} rows")
            if F in BF16_WIDE_F:
                for staged in (False, True):
                    hold_bf16(kind, f, x_wide, DEPTH,
                              f"F={F}, depth {DEPTH}, {TREES} trees, "
                              f"integer leaves, {CHECK_ROWS} rows",
                              staged=staged)
        if F != WIDE_CHECK_F[0]:
            for depth in sorted(set().union(*SHALLOW.values())):
                fe, th, dl, lv = make_forest_arrays(
                    np.random.default_rng(SEED + 10 + depth),
                    integer_leaves=True, trees=37, depth=depth, features=F)
                lv[:, ::3] = -0.0
                f = make_forest(fe, th, lv, default_left=dl, n_features=F,
                                device="cuda")
                for kind in (k for k in KINDS if depth in SHALLOW[k]):
                    for fused in (True, False):
                        for staged in (False, True):
                            hold_wide(kind, f, x_wide, fused, staged, depth,
                                      f"F={F}, depth {depth}, 37 trees, "
                                      f"-0.0 leaves, {CHECK_ROWS} rows")
        del x_wide
    x_far = card_rows(CHECK_ROWS, BF16_PAST_NARROW_F, seed=SEED + 7,
                      missing=0.05, nan_every=16)
    fe, th, dl, lv = make_forest_arrays(
        np.random.default_rng(SEED + 8), integer_leaves=True,
        features=BF16_PAST_NARROW_F)
    f = make_forest(fe, th, lv, default_left=dl,
                    n_features=BF16_PAST_NARROW_F, device="cuda")
    for kind in KINDS:
        hold_bf16(kind, f, x_far, DEPTH,
                  f"F={BF16_PAST_NARROW_F} (past the narrow record), depth "
                  f"{DEPTH}, {TREES} trees, integer leaves, {CHECK_ROWS} "
                  f"rows")
    del x_far, f

    # -- 4. main path ---------------------------------------------------------
    fe, th, dl, lv = make_forest_arrays(np.random.default_rng(SEED + 2),
                                        integer_leaves=False)
    forest = make_forest(fe, th, lv, default_left=dl, n_features=FEATURES,
                         model_type="xgboost", task="classification",
                         device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    t0 = time.perf_counter()
    rows = torch.randn((HIGGS_ROWS, FEATURES), generator=gen, device="cuda")
    store = TensorBlockStore(device="cuda")
    ds = store.put("higgs", rows)
    del rows
    torch.cuda.synchronize()
    log(f"[path] store.put('higgs', {HIGGS_ROWS} x {FEATURES} f32): "
        f"{ds.num_pages} pages of {ds.page_rows} rows, {ds.nbytes} B on "
        f"{ds.data.device}, {time.perf_counter() - t0:.3f} s set-up")
    engine = ForestQueryEngine(store)
    sample = ds.data[:COMPARE_ROWS]
    oracle = predict_proba(forest, sample, algorithm="predicated")
    torch.cuda.synchronize()

    def drive(kind: str, dataset: str, runs: int):
        results, counts = counted(lambda: [
            engine.infer(dataset, forest, plan="udf",
                         algorithm=f"{kind}_pallas_fused")
            for _ in range(runs)])
        batches = sum(r.scan.batches for r in results)
        only(counts, f"{kind}_fused", batches, f"udf {kind}")
        preds = results[-1].predictions
        n = store.get(dataset).num_rows
        if tuple(preds.shape) != (n,) or not bool(torch.isfinite(preds).all()):
            raise AssertionError(f"{kind}: bad predictions {preds.shape}")
        err = float((preds[:COMPARE_ROWS] - oracle).abs().max())
        if not torch.allclose(preds[:COMPARE_ROWS], oracle, rtol=TOL,
                              atol=TOL):
            raise AssertionError(f"{kind}: predictions differ from the eager "
                                 f"oracle by {err}")
        return results, counts[f"{kind}_fused"], err

    res, launches_main, err = drive("predicated", "higgs", runs=2)
    first, second = res
    if first.plan_reuse_hit or not second.plan_reuse_hit:
        raise AssertionError("the repeated query did not hit the plan cache")
    rows_per_s = ds.num_rows / second.total_s
    log(f"[path] infer(plan='udf', algorithm='predicated_pallas_fused') x2: "
        f"plan_reuse_hit={[r.plan_reuse_hit for r in res]}, "
        f"{launches_main} kernel launches for "
        f"{sum(r.scan.batches for r in res)} scan batches, "
        f"first {first.total_s:.6f} s, repeat {second.total_s:.6f} s "
        f"(udf stage {second.infer_s:.6f} s) = {rows_per_s:.1f} rows/s on "
        f"{smi}; max |pred - eager predicated| over {COMPARE_ROWS} rows = "
        f"{err!r}")
    launches = {"predicated_fused": launches_main}
    log(f"[path] cut: the HummingBird and QuickScorer paths score "
        f"{CUT_ROWS} of the {HIGGS_ROWS} rows (their kernels evaluate all "
        f"{(1 << DEPTH) - 1} nodes of every tree, the descent {DEPTH})")
    store.put("higgs_1m", ds.data[:CUT_ROWS])
    for kind in ("hummingbird", "quickscorer"):
        res, launches[f"{kind}_fused"], err = drive(kind, "higgs_1m", runs=1)
        log(f"[path] infer(plan='udf', algorithm='{kind}_pallas_fused') on "
            f"{CUT_ROWS} rows: {launches[f'{kind}_fused']} launches, "
            f"{res[0].total_s:.6f} s = {CUT_ROWS / res[0].total_s:.1f} "
            f"rows/s on {smi}; max |pred - eager predicated| = {err!r}")

    # -- 5. timing ----------------------------------------------------------
    record = []
    for kind in KINDS:
        table = store.get("higgs" if kind == "predicated" else "higgs_1m")
        args, tiles = prepare_inputs(kind, forest, table.data)
        kernel = KERNEL_WRAPPERS[kind]
        reps = 5 if kind == "predicated" else 3
        ms = cuda_ms(lambda: kernel(*args, **tiles), warmup=1, reps=reps)
        got = kernel(*args, **tiles)
        t_plain = time.perf_counter()
        want, plain_ms = timed_plain(plain[kind], args, DEPTH)
        err = float((got - want).abs().max())
        if not torch.allclose(got, want, rtol=TOL, atol=TOL):
            raise AssertionError(f"{kind} at path shapes: max_abs_err {err}")
        max_err[kind] = max(max_err[kind], err)
        bound_ms, bound_by, parts = bound(kind, table.data.shape[0],
                                          FEATURES)
        log(f"[timing] {kind}: {table.data.shape[0]} rows x {TREES} trees, "
            f"tiles {tiles}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
            f"(host {time.perf_counter() - t_plain:.3f} s), bound "
            f"{bound_ms:.4f} ms by {bound_by} ({parts}), kernel/plain "
            f"max_abs_err {err!r}, on {smi}")
        record.append(dict(
            name=f"{kind}_fused", route="cuda", source=SOURCES[kind],
            replaces=REPLACES[kind], launches=None,
            max_abs_err=max_err[kind], ms=ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by, library_ms=None))
    del args, got, want

    # -- 5b. bf16 tree tiles at the path shapes, beside f32 ----------------
    eps_x = card_rows(-(-EPSILON_ROWS // PAGE_ROWS) * PAGE_ROWS, EPSILON_F,
                      seed=SEED + 9)
    fe, th, dl, lv = make_forest_arrays(np.random.default_rng(SEED + 11),
                                        integer_leaves=False,
                                        features=EPSILON_F)
    eps_forest = make_forest(fe, th, lv, default_left=dl,
                             n_features=EPSILON_F, device="cuda")
    shapes = {kind: (("higgs", forest, store.get(
        "higgs" if kind == "predicated" else "higgs_1m").data),
        ("epsilon", eps_forest, eps_x)) for kind in KINDS}
    bf16_out, counts = counted(lambda: {
        (kind, where): predict_sum_pallas(f_, x_,
                                          algorithm=f"{kind}_pallas_fused",
                                          tree_dtype=BF16)
        for kind in KINDS for where, f_, x_ in shapes[kind]})
    expect = {}
    for kind in KINDS:
        expect.update({f"{kind}_fused": 2, f"{kind}_fused_bf16": 2,
                       f"{kind}_fused_wide": 1})
    if {k: n for k, n in counts.items() if n} != expect:
        raise AssertionError(f"bf16 path launches {counts}, expected "
                             f"{expect}")
    rounded = {"higgs": forest.astype(BF16).astype(torch.float32),
               "epsilon": eps_forest.astype(BF16).astype(torch.float32)}
    for (kind, where), got in bf16_out.items():
        x_ = dict((w, x) for w, _, x in shapes[kind])[where]
        want = predict_sum_pallas(rounded[where], x_,
                                  algorithm=f"{kind}_pallas_fused")
        if not torch.equal(bits(got), bits(want)):
            raise AssertionError(f"{kind} bf16 at the {where} shape is not "
                                 f"the f32 path over the rounded forest")
    log(f"[path] predict_sum_pallas(tree_dtype=torch.bfloat16) for each "
        f"fused kernel at the HIGGS and Epsilon shapes: launches {counts}; "
        f"each bit for bit the f32 path over forest.astype(bf16)"
        f".astype(f32)")
    del bf16_out, rounded
    bf16_record = []        # joins the record after the last phase
    for kind in KINDS:
        kernel = KERNEL_WRAPPERS[kind]
        for where, f_, x_ in shapes[kind]:
            a32, t32 = prepare_inputs(kind, f_, x_)
            a16, t16 = prepare_inputs(kind, f_, x_, tree_dtype=BF16)
            reps = 5 if kind == "predicated" else (3 if where == "higgs"
                                                   else 2)
            ms = {"f32": [], "bf16": []}
            for dt in ("f32", "bf16", "bf16", "f32"):
                a, t = (a32, t32) if dt == "f32" else (a16, t16)
                ms[dt].append(cuda_ms(lambda: kernel(*a, **t), warmup=1,
                                      reps=reps))
            ms32, ms16 = (sum(ms[d]) / 2 for d in ("f32", "bf16"))
            B, F = x_.shape
            b32, by32, _ = bound(kind, B, F, f_.num_trees)
            b16, by16, parts = bound(kind, B, F, f_.num_trees, record=4)
            log(f"[timing] {kind} bf16 at {where} {B} rows x {F} features "
                f"x {f_.num_trees} trees: f32 {ms32:.4f} ms (tiles {t32}), "
                f"bf16 {ms16:.4f} ms (tiles {t16}), bf16/f32 "
                f"{ms16 / ms32:.4f}; bound f32 {b32:.4f} ms by {by32}, bf16 "
                f"{b16:.4f} ms by {by16} ({parts}); on {smi}")
            if where != "higgs":
                continue
            # the narrow record at the f32 launch's own tiles: what the
            # record's decode costs, apart from the larger tree tile
            same, t_same = prepare_inputs(kind, f_, x_, tree_dtype=BF16,
                                          block_b=t32["block_b"],
                                          block_t=t32["block_t"])
            same_ms = cuda_ms(lambda: kernel(*same, **t_same), warmup=1,
                              reps=reps)
            log(f"[timing] {kind} bf16 at the f32 tiles {t_same}: "
                f"{same_ms:.4f} ms, /f32 {same_ms / ms32:.4f}; on {smi}")
            del same
            got = kernel(*a16, **t16)
            want, plain_ms = timed_plain(plain[kind], a16, DEPTH)
            err = float((got - want).abs().max())
            if not torch.equal(bits(got), bits(want)):
                raise AssertionError(f"{kind} bf16 at the path shape: "
                                     f"max_abs_err {err}")
            bf16_err[kind] = max(bf16_err[kind], err)
            log(f"[timing] {kind} bf16 plain version: {plain_ms:.4f} ms, "
                f"kernel/plain bit for bit; on {smi}")
            bf16_record.append(dict(
                name=f"{kind}_fused_bf16", route="cuda",
                source=SOURCES[kind], replaces=REPLACES[kind],
                launches=counts[f"{kind}_fused_bf16"],
                max_abs_err=bf16_err[kind], ms=ms16, plain_ms=plain_ms,
                bound_ms=b16, bound_by=by16, library_ms=None))
            del got, want
        del a32, a16
    del eps_x, eps_forest, shapes

    # -- 6. the relation-centric plans at 1600 trees ----------------------
    # Leaves shrink with the tree count, as boosting's step size does, so
    # the margin keeps the 500-tree forest's spread.
    fe, th, dl, lv = make_forest_arrays(
        np.random.default_rng(SEED + 3), integer_leaves=False,
        trees=REL_TREES, leaf_scale=0.1 * math.sqrt(TREES / REL_TREES))
    big = make_forest(fe, th, lv, default_left=dl, n_features=FEATURES,
                      model_type="xgboost", task="classification",
                      device="cuda")
    big_oracle = predict_proba(big, sample, algorithm="predicated")
    torch.cuda.synchronize()        # no query below waits on the oracle

    def hold(preds: torch.Tensor, n: int, what: str) -> float:
        if tuple(preds.shape) != (n,) or not bool(torch.isfinite(preds).all()):
            raise AssertionError(f"{what}: bad predictions {preds.shape}")
        k = min(n, COMPARE_ROWS)
        err = float((preds[:k] - big_oracle[:k]).abs().max())
        if not torch.allclose(preds[:k], big_oracle[:k], rtol=TOL, atol=TOL):
            raise AssertionError(f"{what}: predictions differ from the eager "
                                 f"oracle by {err}")
        return err

    def breakdown(r) -> str:
        stages = ", ".join(f"{s.name} {s.seconds:.6f} s"
                           for s in r.stage_reports)
        return (f"total {r.total_s:.6f} s (partition {r.partition_s:.6f}, "
                f"infer {r.infer_s:.6f}, aggregate "
                f"{r.aggregate_s:.6f}; {stages})")

    def rel_run(dataset: str, plan: str, algorithm: str, runs: int):
        """``runs`` queries, each with its launches counted on its own."""
        kind = algorithm.split("_")[0]
        name_ = f"{kind}_{'fused' if algorithm.endswith('_fused') else 'raw'}"
        n = store.get(dataset).num_rows
        results, counts = [], {k: 0 for k in wrappers}
        for i in range(runs):
            r, c = counted(lambda: engine.infer(dataset, big, plan=plan,
                                                algorithm=algorithm))
            only(c, name_, r.n_parts * r.scan.batches,
                 f"{plan} {algorithm} run {i + 1}")
            err = hold(r.predictions, n, f"{plan} {algorithm}")
            log(f"[rel] infer(plan='{plan}', algorithm='{algorithm}') run "
                f"{i + 1} over {n} rows x {REL_TREES} trees: n_parts="
                f"{r.n_parts}, reuse_hit={r.reuse_hit}, plan_reuse_hit="
                f"{r.plan_reuse_hit}, {breakdown(r)} = "
                f"{n / r.total_s:.1f} rows/s on {smi}; {c[name_]} {name_} "
                f"launches = n_parts x scan batches, no other kernel; max "
                f"|pred - eager predicated| over {min(n, COMPARE_ROWS)} "
                f"rows = {err!r}")
            results.append(r)
            for k, v in c.items():
                counts[k] = counts.get(k, 0) + v
        return results, counts

    totals = {k: 0 for k in wrappers}

    def tally(counts: dict) -> None:
        for k, n in counts.items():
            totals[k] = totals.get(k, 0) + n

    res, counts = rel_run("higgs", "rel+reuse", "predicated_pallas", runs=2)
    tally(counts)
    first, second = res
    if first.reuse_hit or not (second.reuse_hit and second.plan_reuse_hit) \
            or second.partition_s != 0.0:
        raise AssertionError("the repeated rel+reuse query did not hit both "
                             "caches")
    rel_parts = first.n_parts
    rel_device_s = second.total_s
    if rel_parts != -(-REL_TREES // default_tree_block(big, fused=False)):
        raise AssertionError(f"n_parts {rel_parts} is not one partition "
                             f"per raw tree tile")
    res, counts = rel_run("higgs", "rel", "predicated_pallas", runs=1)
    tally(counts)
    if res[0].reuse_hit:
        raise AssertionError("plan='rel' consulted a cache")
    profile_query(lambda: engine.infer("higgs", big, plan="rel+reuse",
                                       algorithm="predicated_pallas"),
                  "rel+reuse predicated_pallas, repeat", smi)

    for plan, algorithm, variant in (
            ("udf", "predicated_pallas_fused", "fused"),
            ("rel+reuse", "predicated_pallas", "raw")):
        for B in ROW_BATCHES:
            x = ds.data[:B]
            mask = np.arange(B) < B - B // 4           # coalescer padding
            calls, counts = counted(lambda: [
                engine.infer_rows(big, x, row_mask=mask, plan=plan,
                                  algorithm=algorithm) for _ in range(2)])
            n_parts = rel_parts if plan == "rel+reuse" else 1
            only(counts, f"predicated_{variant}", 2 * n_parts,
                 f"infer_rows {plan} {B}")
            tally(counts)
            if calls[0].plan_reuse_hit or not calls[1].plan_reuse_hit:
                raise AssertionError(f"infer_rows {plan} {B}: the repeat "
                                     f"missed the plan cache")
            keep = torch.from_numpy(mask).cuda()
            preds = calls[1].predictions
            err = float((preds[keep] - big_oracle[:B][keep]).abs().max())
            if not (torch.allclose(preds[keep], big_oracle[:B][keep],
                                   rtol=TOL, atol=TOL)
                    and bool(torch.isnan(preds[~keep]).all())):
                raise AssertionError(f"infer_rows {plan} {B}: wrong rows")
            log(f"[rows] infer_rows({B} rows, {int(mask.sum())} real, plan="
                f"'{plan}', algorithm='{algorithm}') x2: "
                f"{counts[f'predicated_{variant}']} launches, first "
                f"{calls[0].total_s:.6f} s, repeat {calls[1].total_s:.6f} s "
                f"on {smi}; max |pred - eager predicated| = {err!r}")

    for kind in ("hummingbird", "quickscorer"):
        res, counts = rel_run("higgs_1m", "rel+reuse", f"{kind}_pallas",
                              runs=2)
        tally(counts)
        if not (res[1].reuse_hit and res[1].plan_reuse_hit):
            raise AssertionError(f"the repeated rel+reuse {kind} query did "
                                 f"not hit both caches")
    res, counts = rel_run("higgs_1m", "udf", "predicated_pallas", runs=1)
    tally(counts)
    for name_ in ("predicated_fused", "hummingbird_fused",
                  "quickscorer_fused"):
        launches[name_] += totals[name_]
    for kind in KINDS:
        launches[f"{kind}_raw"] = totals[f"{kind}_raw"]
    for entry in record:
        entry["launches"] = launches[entry["name"]]

    # -- 7. raw kernel timing at one rel launch's shape ----------------------
    part = tree_slice(big, 0, REL_TREES // rel_parts)
    for kind in KINDS:
        table = store.get("higgs" if kind == "predicated" else "higgs_1m")
        args, tiles = prepare_inputs(kind, part, table.data, fused=False)
        kernel = RAW_KERNEL_WRAPPERS[kind]
        ms = cuda_ms(lambda: kernel(*args, **tiles), warmup=2, reps=10)
        got = kernel(*args, **tiles)
        t_plain = time.perf_counter()
        want, plain_ms = timed_plain(raw_plain[kind], args, DEPTH)
        err = float((got - want).abs().max())
        if not torch.equal(bits(got), bits(want)):
            raise AssertionError(f"{kind} raw at path shapes: max_abs_err "
                                 f"{err}")
        raw_err[kind] = max(raw_err[kind], err)
        B, T = got.shape
        bound_ms, bound_by, parts = bound(kind, B, FEATURES, T, raw=True)
        log(f"[timing] {kind} raw: {B} rows x {T} trees, tiles {tiles}: "
            f"kernel {ms:.4f} ms ({got.nbytes / ms / 1e6:.1f} GB/s of "
            f"[B, T] written), plain {plain_ms:.4f} ms (host "
            f"{time.perf_counter() - t_plain:.3f} s), bound {bound_ms:.4f} "
            f"ms by {bound_by} ({parts}), kernel/plain max_abs_err {err!r}, "
            f"on {smi}")
        # the same partition through the fused kernel, and the
        # aggregate_raw the rel plan runs on each raw output
        fargs, ftiles = prepare_inputs(kind, part, table.data)
        fused_ms = cuda_ms(lambda: KERNEL_WRAPPERS[kind](*fargs, **ftiles),
                           warmup=2, reps=10)
        sum_ms = cuda_ms(lambda: torch.sum(got, dim=-1), warmup=2, reps=10)
        log(f"[timing] {kind} at the same {T}-tree partition: fused kernel "
            f"{fused_ms:.4f} ms (tiles {ftiles}), raw - fused "
            f"{ms - fused_ms:.4f} ms, aggregate_raw (torch.sum over the "
            f"[B, T] output) {sum_ms:.4f} ms, on {smi}")
        del fargs
        record.append(dict(
            name=f"{kind}_raw", route="cuda", source=SOURCES[kind],
            replaces=RAW_REPLACES[kind], launches=launches[f"{kind}_raw"],
            max_abs_err=raw_err[kind], ms=ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by, library_ms=None))
        del args, got, want

    # -- 8. the host and disk tiers ------------------------------------------
    fused_ms = next(e["ms"] for e in record
                    if e["name"] == "predicated_fused")
    for name_, n in tiers_phase(
            forest=forest, big=big, store=store, engine=engine,
            counted=counted, only=only, smi=smi, fused_ms=fused_ms,
            rel_device_s=rel_device_s).items():
        next(e for e in record if e["name"] == name_)["launches"] += n

    # -- 9. wide rows and the sparse plane ----------------------------------
    counts9: dict[str, int] = {}

    def tally9(counts: dict) -> None:
        for k, n in counts.items():
            counts9[k] = counts9.get(k, 0) + n

    wide = sparse_phase(counted=counted, only=only, smi=smi, tally=tally9)
    for entry in record:
        name_ = entry["name"]
        entry["launches"] += counts9[name_] - counts9[f"{name_}_wide"]
    for kind in KINDS:
        for variant, replaces in (("fused", REPLACES), ("raw", RAW_REPLACES)):
            name_ = f"{kind}_{variant}_wide"
            if not counts9[name_]:
                raise AssertionError(f"{name_}: no launch on phase 9's path")
            w = wide[name_]
            record.append(dict(
                name=name_, route="cuda", source=SOURCES[kind],
                replaces=replaces[kind], launches=counts9[name_],
                max_abs_err=max(wide_err[name_], w["max_abs_err"]),
                ms=w["ms"], plain_ms=w["plain_ms"], bound_ms=w["bound_ms"],
                bound_by=w["bound_by"], library_ms=None))

    # -- 10. external loads against in-database inference -------------------
    counts10: dict[str, int] = {}

    def tally10(counts: dict) -> None:
        for k, n in counts.items():
            counts10[k] = counts10.get(k, 0) + n

    t10 = time.perf_counter()
    load_phase(counted=counted, only=only, smi=smi, tally=tally10)
    log(f"[load] phase wall {time.perf_counter() - t10:.3f} s")
    for entry in record:
        name_ = entry["name"]
        if name_.endswith("_wide"):
            entry["launches"] += counts10[name_]
        else:
            entry["launches"] += counts10[name_] - counts10[f"{name_}_wide"]
    record.extend(bf16_record)

    log(f"[smoke] wall {time.perf_counter() - t_start:.3f} s")

    print(json.dumps({"kernels": record}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
