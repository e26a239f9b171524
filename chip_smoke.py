"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. report   the card's name, the device count, name and power limit;
  2. build    the CUDA kernels from src/repro_torch/kernels/csrc with nvcc
              (each library holds one kernel's fused and raw entry points);
  3. kernels  each fused and each raw kernel against its plain PyTorch
              version at depth 8, 500 trees, 28 features on 16,384 rows
              with NaN rows: fused sums bit-identical on integer leaves and
              within TOL on float leaves, raw [B, T] scores bit-identical;
  4. path     the in-database query on a HIGGS-shaped table (11,000,000 x
              28 rows from a seed, on the device tier):
              infer(plan="udf", algorithm="predicated_pallas_fused") twice
              (the second must hit the plan cache), launches counted,
              predictions held against the eager "predicated" algorithm;
              then the HummingBird and QuickScorer kernels over 1,000,000
              rows of the same table;
  5. timing   each fused kernel at the shapes the path gave it (CUDA events
              over warmed-up repeats) beside its bound and its plain version;
  6. rel      the relation-centric plans at the large-model shape (1600
              depth-8 trees): infer(plan="rel+reuse",
              algorithm="predicated_pallas") twice over the 11M-row table
              (the repeat hits the model and the plan cache), plan="rel"
              once, infer_rows at 8/32/128 rows (udf with the fused kernel,
              rel+reuse with the raw one, each called twice), the
              HummingBird and QuickScorer raw kernels through rel+reuse on
              the 1M-row cut, and udf with predicated_pallas (one raw
              launch over all 1600 trees) on that cut.  Every run counts
              launches (raw = n_parts x scan batches, no other kernel) and
              holds its first rows against the eager oracle;
  7. timing   each raw kernel at one rel launch's shape (16 trees).
The last lines are the kernels' JSON record, the nvidia-smi line, and
{"ok": true, "device": {...}}.

It imports nothing of the JAX package.  The forests' weights and the table
are random, made from SEED, at the published HIGGS shape (depth-8 XGBoost
trees over 28 features; 500 trees, and 1600 for the rel plans).
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

SEED = 0
DEPTH, TREES, FEATURES = 8, 500, 28
REL_TREES = 1600                # the large-model regime of the rel plans
HIGGS_ROWS = 11_000_000
CUT_ROWS = 1_000_000            # HummingBird / QuickScorer path rows
CHECK_ROWS = 16_384             # phase 3 kernel-vs-plain rows
COMPARE_ROWS = 65_536           # path rows held against the oracle
ROW_BATCHES = (8, 32, 128)      # the serving plane's bucket ladder
TOL = 1e-6                      # rtol = atol for float sums (order differs)
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
                       leaf_scale: float = 0.1):
    I, L = (1 << DEPTH) - 1, 1 << DEPTH
    feature = rng.integers(0, FEATURES, (trees, I)).astype(np.int32)
    threshold = rng.normal(size=(trees, I)).astype(np.float32)
    default_left = rng.random((trees, I)) < 0.5
    if integer_leaves:
        leaves = rng.integers(-8, 9, (trees, L)).astype(np.float32)
    else:
        leaves = (leaf_scale * rng.normal(size=(trees, L))).astype(
            np.float32)
    return feature, threshold, default_left, leaves


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
          raw: bool = False) -> tuple[float, str, dict]:
    """Least time (ms) the card could take for one launch over B rows and
    T trees: the larger of bytes over HBM rate and operations over peak.
    Bytes: x read once, the trees and structure tensors read once, the
    output ([B], or [B, T] for a raw launch) written once."""
    I, L = (1 << DEPTH) - 1, 1 << DEPTH
    W = (L + 31) // 32
    nbytes = 4 * B * F + T * (9 * I + 4 * L) + 4 * B * (T if raw else 1)
    pairs = B * T
    add = 0 if raw else 1         # the fused kernels add each pair's leaf
    if kind == "predicated":      # depth compares (+ 1 add) per pair
        ops, rate = pairs * (DEPTH + add), SCALAR_OPS_PER_S
    elif kind == "hummingbird":   # S.C contraction: I x L MACs per pair
        ops, rate = pairs * I * L * 2, INT8_TENSOR_OPS_PER_S
        nbytes += 8 * L * ((I + 31) // 32) + 4 * L
    else:                         # I compares + I*W ANDs + W ffs (+ 1 add)
        ops, rate = pairs * (I * (1 + W) + W + add), SCALAR_OPS_PER_S
        nbytes += 4 * I * W
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / rate * 1e3
    by = "bytes" if bytes_ms >= ops_ms else "operations"
    return max(bytes_ms, ops_ms), by, dict(bytes=nbytes, ops=ops,
                                           bytes_ms=bytes_ms, ops_ms=ops_ms)


def profile_query(run, what: str, smi: str, top: int = 8) -> None:
    """One run under torch.profiler: device time by kernel and the share
    of the run's wall time the card was busy (kernels do not overlap on
    the one stream)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            entry = by_name.setdefault(e.name[:90], [0, 0.0])
            entry[0] += 1
            entry[1] += e.time_range.elapsed_us()
    busy_us = sum(us for _, us in by_name.values())
    log(f"[profile] {what}: wall {wall_us / 1e3:.3f} ms under the profiler, "
        f"device busy {busy_us / 1e3:.3f} ms = {100 * busy_us / wall_us:.1f} "
        f"% (idle {100 - 100 * busy_us / wall_us:.1f} %), on {smi}")
    for kname, (n, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1]
                                 )[:top]:
        log(f"[profile]   {us / 1e3:10.3f} ms  {n:5d} x  {kname}")


def main() -> int:
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
                                         default_tree_block, prepare_inputs)

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
        """Run ``run()`` with every kernel's launch count set to 0 just
        before; return its result and the counts just after."""
        for w in wrappers.values():
            w.launches = 0
        out = run()
        torch.cuda.synchronize()
        return out, {name: w.launches for name, w in wrappers.items()}

    def only(counts: dict, name: str, want: int, what: str) -> None:
        if counts[name] != want or want == 0:
            raise AssertionError(f"{what}: {counts[name]} {name} launches, "
                                 f"expected {want}")
        stray = {k: n for k, n in counts.items() if k != name and n}
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
        regs = sorted({ln.split(":", 1)[1].strip() for ln in text.splitlines()
                       if "registers" in ln})
        log(f"[build] {lib}: {'; '.join(regs)}")

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
            ok = torch.equal(got, want) and bool(torch.isfinite(got).all())
            log(f"[kernels] {kind} raw {'integer' if integer else 'float'} "
                f"leaves, {CHECK_ROWS} rows x {TREES} trees, tiles {tiles}: "
                f"max_abs_err={err!r} bit-identical: "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{kind} raw kernel disagrees with its "
                                     f"plain version")

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
        kind = algorithm.split("_")[0]
        variant = "fused" if algorithm.endswith("_fused") else "raw"
        results, counts = counted(lambda: [
            engine.infer(dataset, big, plan=plan, algorithm=algorithm)
            for _ in range(runs)])
        want = sum(r.n_parts * r.scan.batches for r in results)
        only(counts, f"{kind}_{variant}", want, f"{plan} {algorithm}")
        n = store.get(dataset).num_rows
        err = max(hold(r.predictions, n, f"{plan} {algorithm}")
                  for r in results)
        for i, r in enumerate(results):
            log(f"[rel] infer(plan='{plan}', algorithm='{algorithm}') run "
                f"{i + 1} over {n} rows x {REL_TREES} trees: n_parts="
                f"{r.n_parts}, reuse_hit={r.reuse_hit}, plan_reuse_hit="
                f"{r.plan_reuse_hit}, {breakdown(r)} = "
                f"{n / r.total_s:.1f} rows/s on {smi}")
        log(f"[rel] {plan} {algorithm}: {counts[f'{kind}_{variant}']} "
            f"{kind}_{variant} launches = n_parts x scan batches; max |pred "
            f"- eager predicated| over {min(n, COMPARE_ROWS)} rows = {err!r}")
        return results, counts

    totals = {k: 0 for k in wrappers}

    def tally(counts: dict) -> None:
        for k, n in counts.items():
            totals[k] += n

    res, counts = rel_run("higgs", "rel+reuse", "predicated_pallas", runs=2)
    tally(counts)
    first, second = res
    if first.reuse_hit or not (second.reuse_hit and second.plan_reuse_hit) \
            or second.partition_s != 0.0:
        raise AssertionError("the repeated rel+reuse query did not hit both "
                             "caches")
    rel_parts = first.n_parts
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
                              runs=1)
        tally(counts)
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
        if not torch.equal(got, want):
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

    print(json.dumps({"kernels": record}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
