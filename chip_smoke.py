"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. report   the card's name, the device count, name and power limit;
  2. build    the CUDA kernels from src/repro_torch/kernels/csrc with nvcc;
  3. kernels  each fused kernel against its plain PyTorch version at depth
              8, 500 trees, 28 features on 16,384 rows with NaN rows:
              bit-identical on integer leaves, within TOL on float leaves;
  4. path     the in-database query on a HIGGS-shaped table (11,000,000 x
              28 rows from a seed, on the device tier):
              infer(plan="udf", algorithm="predicated_pallas_fused") twice
              (the second must hit the plan cache), launches counted,
              predictions held against the eager "predicated" algorithm;
              then the HummingBird and QuickScorer kernels over 1,000,000
              rows of the same table;
  5. timing   each kernel at the shapes the path gave it (CUDA events over
              warmed-up repeats) beside its bound and its plain version.
The last lines are the kernels' JSON record, the nvidia-smi line, and
{"ok": true, "device": {...}}.

It imports nothing of the JAX package.  The forest's weights and the table
are random, made from SEED, at the published HIGGS shape (depth-8 XGBoost
trees over 28 features, 500 trees).
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

SEED = 0
DEPTH, TREES, FEATURES = 8, 500, 28
HIGGS_ROWS = 11_000_000
CUT_ROWS = 1_000_000            # HummingBird / QuickScorer path rows
CHECK_ROWS = 16_384             # phase 3 kernel-vs-plain rows
COMPARE_ROWS = 65_536           # phase 4 rows held against the oracle
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


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def make_forest_arrays(rng, *, integer_leaves: bool):
    I, L = (1 << DEPTH) - 1, 1 << DEPTH
    feature = rng.integers(0, FEATURES, (TREES, I)).astype(np.int32)
    threshold = rng.normal(size=(TREES, I)).astype(np.float32)
    default_left = rng.random((TREES, I)) < 0.5
    if integer_leaves:
        leaves = rng.integers(-8, 9, (TREES, L)).astype(np.float32)
    else:
        leaves = (0.1 * rng.normal(size=(TREES, L))).astype(np.float32)
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


def bound(kind: str, B: int, F: int) -> tuple[float, str, dict]:
    """Least time (ms) the card could take for one fused launch over B
    rows: the larger of bytes over HBM rate and operations over peak."""
    I, L = (1 << DEPTH) - 1, 1 << DEPTH
    W = (L + 31) // 32
    nbytes = 4 * B * F + TREES * (9 * I + 4 * L) + 4 * B   # x, trees, out
    pairs = B * TREES
    if kind == "predicated":      # depth compares + 1 add per pair
        ops, rate = pairs * (DEPTH + 1), SCALAR_OPS_PER_S
    elif kind == "hummingbird":   # S.C contraction: I x L MACs per pair
        ops, rate = pairs * I * L * 2, INT8_TENSOR_OPS_PER_S
        nbytes += 8 * L * ((I + 31) // 32) + 4 * L
    else:                         # I compares + I*W ANDs + W ffs + 1 add
        ops, rate = pairs * (I * (1 + W) + W + 1), SCALAR_OPS_PER_S
        nbytes += 4 * I * W
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / rate * 1e3
    by = "bytes" if bytes_ms >= ops_ms else "operations"
    return max(bytes_ms, ops_ms), by, dict(bytes=nbytes, ops=ops,
                                           bytes_ms=bytes_ms, ops_ms=ops_ms)


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
    from repro_torch.core.forest import make_forest
    from repro_torch.core.postprocess import predict_proba
    from repro_torch.db.query import ForestQueryEngine
    from repro_torch.db.store import TensorBlockStore
    from repro_torch.kernels import _build
    from repro_torch.kernels.forest_hummingbird import hummingbird_fused_plain
    from repro_torch.kernels.forest_predicated import predicated_fused_plain
    from repro_torch.kernels.forest_quickscorer import quickscorer_fused_plain
    from repro_torch.kernels.ops import KERNEL_WRAPPERS, prepare_inputs

    plain = dict(predicated=predicated_fused_plain,
                 hummingbird=hummingbird_fused_plain,
                 quickscorer=quickscorer_fused_plain)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

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

    def drive(kind: str, dataset: str, runs: int):
        for w in KERNEL_WRAPPERS.values():
            w.launches = 0
        results = [engine.infer(dataset, forest, plan="udf",
                                algorithm=f"{kind}_pallas_fused")
                   for _ in range(runs)]
        torch.cuda.synchronize()
        counts = {k: w.launches for k, w in KERNEL_WRAPPERS.items()}
        batches = sum(r.scan.batches for r in results)
        if counts[kind] != batches or counts[kind] == 0:
            raise AssertionError(f"{kind}: {counts[kind]} launches for "
                                 f"{batches} scan batches")
        for other in KINDS:
            if other != kind and counts[other]:
                raise AssertionError(f"{other} launched on the {kind} path")
        preds = results[-1].predictions
        n = store.get(dataset).num_rows
        if tuple(preds.shape) != (n,) or not bool(torch.isfinite(preds).all()):
            raise AssertionError(f"{kind}: bad predictions {preds.shape}")
        err = float((preds[:COMPARE_ROWS] - oracle).abs().max())
        if not torch.allclose(preds[:COMPARE_ROWS], oracle, rtol=TOL,
                              atol=TOL):
            raise AssertionError(f"{kind}: predictions differ from the eager "
                                 f"oracle by {err}")
        return results, counts[kind], err

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
    launches = {"predicated": launches_main}
    log(f"[path] cut: the HummingBird and QuickScorer paths score "
        f"{CUT_ROWS} of the {HIGGS_ROWS} rows (their kernels evaluate all "
        f"{(1 << DEPTH) - 1} nodes of every tree, the descent {DEPTH})")
    store.put("higgs_1m", ds.data[:CUT_ROWS])
    for kind in ("hummingbird", "quickscorer"):
        res, launches[kind], err = drive(kind, "higgs_1m", runs=1)
        log(f"[path] infer(plan='udf', algorithm='{kind}_pallas_fused') on "
            f"{CUT_ROWS} rows: {launches[kind]} launches, "
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
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        want = plain_rows(plain[kind], args, DEPTH, rows=262_144)
        end.record()
        end.synchronize()
        plain_ms = start.elapsed_time(end)
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
            replaces=REPLACES[kind], launches=launches[kind],
            max_abs_err=max_err[kind], ms=ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by, library_ms=None))

    print(json.dumps({"kernels": record}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
