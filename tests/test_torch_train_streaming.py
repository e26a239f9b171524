"""Port parity: in-database streamed training (``repro_torch.db.train``,
``ForestQueryEngine.train``) on the CPU.

  * the bit-identity matrix: ``engine.train`` equals the port's resident
    ``core.train.train_forest`` (same edges) bit for bit for
    {host, disk, device} tier x {dense, CSR} x the three families, at two
    batch geometries, and any batch size or prefetch depth gives the same
    forest;
  * against the reference engine's ``train`` on the same stored rows: the
    sketch's edges bit for bit, regression forests bit for bit, and
    classification with the same splits and leaves within 1e-6
    (``tests/test_torch_train.py`` states why);
  * the store and executor hooks the trainer rides: ``stream_writer``'s
    ``dtype`` / ``fill`` / ``labels`` on each tier, ``execute``'s
    ``extras`` / ``on_batch`` and ``result_key=None``;
  * the reference's ``tests/test_train_streaming.py`` claims, each a case:
    the scan stats, the bins relation, ``num_bins > 255`` and unlabelled
    datasets refused, the model landing and serving, the spans and
    counters, re-training's sweeps, and a same-forest re-put that sweeps
    nothing.

Stores use the reference test's shapes: ``N, F = 700, 9``, ``PAGE = 64``,
10 % NaN, budgets that force the tier.
"""

import numpy as np
import pytest
import torch

from repro.core.train import TrainConfig as JConfig
from repro.db.query import ForestQueryEngine as JEngine
from repro.db.store import TensorBlockStore as JStore
from repro_torch.core.reuse import ModelReuseCache
from repro_torch.core.train import (TrainConfig, quantile_bin_edges,
                                    train_forest)
from repro_torch.db.executor import StreamingScanExecutor
from repro_torch.db.operators import Operator, split_into_stages
from repro_torch.db.query import ForestQueryEngine
from repro_torch.db.store import TensorBlockStore
from repro_torch.obs import METRICS, TRACER

from test_torch_train import (assert_forests_bitwise, assert_forests_close,
                              port_cfg)

PAGE = 64
N, F = 700, 9
FAMILIES = ("randomforest", "xgboost", "lightgbm")
TIERS = ("host", "disk", "device")


def _data(seed=0, nan_frac=0.1, regression=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, F)).astype(np.float32)
    w = rng.normal(size=F).astype(np.float32)
    s = np.nan_to_num(x) @ w
    y = (s if regression else (s > 0)).astype(np.float32)
    if nan_frac:
        x[rng.random(x.shape) < nan_frac] = np.nan
    return x, y


def _budgets(tier):
    if tier == "device":
        return {}
    kw = dict(device_budget_bytes=16 << 10)
    if tier == "disk":
        kw["host_budget_bytes"] = 8 << 10
    return kw


def _store(tier, *, fmt="dense", data=None, tmp_path=None):
    """A port store whose budgets force ``tier`` for the test dataset."""
    x, y = data if data is not None else _data()
    store = TensorBlockStore("cpu", default_page_rows=PAGE,
                             spill_dir=str(tmp_path) if tmp_path else None,
                             **_budgets(tier))
    put = store.put_sparse if fmt == "csr" else store.put
    put("d", x, labels=y, tier="auto")
    assert store.get("d").tier == tier
    return store, x, y


def _jstore(tier, *, fmt, x, y):
    store = JStore(default_page_rows=PAGE, **_budgets(tier))
    put = store.put_sparse if fmt == "csr" else store.put
    put("d", x, labels=y, tier="auto")
    assert store.get("d").tier == tier
    return store


def _same(a, b) -> bool:
    return all(torch.equal(u, getattr(b, k)) for k, u in a.arrays().items())


# -- the bit-identity matrix: streamed == resident, on the port ---------------


@pytest.mark.parametrize("batch_pages", [1, 4])
@pytest.mark.parametrize("model_type", FAMILIES)
@pytest.mark.parametrize("fmt", ["dense", "csr"])
@pytest.mark.parametrize("tier", TIERS)
def test_streamed_matches_resident(tier, fmt, model_type, batch_pages,
                                   tmp_path):
    store, x, y = _store(tier, fmt=fmt, tmp_path=tmp_path)
    cfg = TrainConfig(model_type=model_type, num_trees=3, max_depth=3,
                      num_bins=16, colsample=0.6, seed=3)
    edges = quantile_bin_edges(x, cfg.num_bins)
    ref = train_forest(x, y, cfg, edges=edges, device="cpu")
    res = ForestQueryEngine(store).train("d", cfg, edges=edges,
                                         batch_pages=batch_pages)
    for name, arr in ref.arrays().items():
        got = getattr(res.forest, name)
        assert got.dtype == arr.dtype, name
        assert torch.equal(got, arr), f"{tier}/{fmt}/{model_type} {name}"
    assert (res.tier, res.storage_format) == (tier, fmt)
    assert res.materialized_full_x is False
    assert res.num_scans == 1 + cfg.num_trees * (cfg.max_depth + 1)


def test_batch_geometry_never_changes_the_forest():
    store, x, y = _store("host")
    cfg = TrainConfig(num_trees=3, max_depth=3, num_bins=16)
    edges = quantile_bin_edges(x, cfg.num_bins)
    eng = ForestQueryEngine(store)
    base = eng.train("d", cfg, edges=edges, batch_pages=1).forest
    for bp, depth in ((2, 2), (3, 1), (7, 2), (11, 1)):
        got = eng.train("d", cfg, edges=edges, batch_pages=bp,
                        prefetch_depth=depth).forest
        assert _same(base, got), (bp, depth)


# -- against the reference engine ---------------------------------------------


@pytest.mark.parametrize("model_type", FAMILIES)
@pytest.mark.parametrize("fmt", ["dense", "csr"])
@pytest.mark.parametrize("tier", ["host", "disk"])
def test_regression_equals_the_reference_engine(tier, fmt, model_type):
    """The sketch's edges and the forest, bit for bit: the same stride
    sample, the same draws, the same histograms."""
    x, y = _data(seed=2, regression=True)
    jcfg = JConfig(model_type=model_type, task="regression", num_trees=3,
                   max_depth=3, num_bins=16, colsample=0.6,
                   learning_rate=0.3, seed=4)
    jres = JEngine(_jstore(tier, fmt=fmt, x=x, y=y)).train(
        "d", jcfg, sketch_rows=200, batch_pages=3)
    store, _, _ = _store(tier, fmt=fmt, data=(x, y))
    res = ForestQueryEngine(store).train("d", port_cfg(jcfg),
                                         sketch_rows=200, batch_pages=3)
    np.testing.assert_array_equal(res.edges, np.asarray(jres.edges))
    assert res.sketch_rows_used == jres.sketch_rows_used
    assert res.num_scans == jres.num_scans
    assert_forests_bitwise(jres.forest, res.forest, f"{tier}/{fmt}")
    for a, b in zip(res.scan_stats, jres.scan_stats):
        assert (a.tier, a.batches, a.batch_pages) == \
            (b.tier, b.batches, b.batch_pages)


@pytest.mark.parametrize("model_type", FAMILIES)
@pytest.mark.parametrize("tier", ["host", "disk"])
def test_classification_within_tolerance_of_the_reference_engine(
        tier, model_type):
    x, y = _data(seed=6)
    jcfg = JConfig(model_type=model_type, num_trees=4, max_depth=3,
                   num_bins=16, colsample=0.6, learning_rate=0.3, seed=1)
    edges = quantile_bin_edges(x, jcfg.num_bins)
    jres = JEngine(_jstore(tier, fmt="dense", x=x, y=y)).train(
        "d", jcfg, edges=edges)
    store, _, _ = _store(tier, data=(x, y))
    res = ForestQueryEngine(store).train("d", port_cfg(jcfg), edges=edges)
    if model_type == "randomforest":
        assert_forests_bitwise(jres.forest, res.forest, tier)
    assert_forests_close(jres.forest, res.forest, x, f"{tier}/{model_type}")


# -- the hooks: stream_writer and the executor --------------------------------


@pytest.mark.parametrize("tier", TIERS)
def test_stream_writer_dtype_fill_labels(tier, tmp_path):
    store = TensorBlockStore("cpu", default_page_rows=PAGE,
                             spill_dir=str(tmp_path))
    rows = np.arange(100 * 3, dtype=np.int64).reshape(100, 3) % 200
    labels = np.arange(100, dtype=np.float32)
    w = store.stream_writer("b", num_rows=100, num_features=3,
                            dtype=torch.uint8, tier=tier, fill=17,
                            labels=labels)
    for lo in range(0, 100, 30):
        w.write(torch.from_numpy(rows[lo:lo + 30]))
    ds = w.close()
    assert ds.tier == tier and ds.dtype == torch.uint8
    assert ds.nbytes == 128 * 3                       # uint8 itemsize
    host = np.asarray(ds.data if tier == "disk" else ds.data.numpy())
    assert host.dtype == np.uint8
    np.testing.assert_array_equal(host[:100], rows.astype(np.uint8))
    assert (host[100:] == 17).all()
    np.testing.assert_array_equal(ds.labels.numpy(), labels)
    assert store.catalog()["b"]["bytes"] == 128 * 3
    with pytest.raises(ValueError, match="labels"):
        store.stream_writer("c", num_rows=5, num_features=1,
                            labels=np.zeros(4))


def test_stream_writer_cascade_counts_the_dtype_bytes():
    """A uint8 relation takes a quarter of the float32 budget."""
    store = TensorBlockStore("cpu", default_page_rows=PAGE,
                             device_budget_bytes=128 * 8)
    w = store.stream_writer("u8", num_rows=128, num_features=8,
                            dtype=torch.uint8)
    assert w.tier == "device"
    w.abort()
    w = store.stream_writer("f32", num_rows=128, num_features=8)
    assert w.tier == "host"
    w.abort()


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("tier", TIERS)
def test_execute_extras_on_batch_and_no_result(tier, depth, tmp_path):
    x, _ = _data(nan_frac=0)
    store = TensorBlockStore("cpu", default_page_rows=PAGE,
                             spill_dir=str(tmp_path))
    store.put("d", x, tier=tier)
    ds = store.get("d")
    seen = []

    def extras(first, n):
        return {"k": torch.full((n * PAGE,), first, dtype=torch.int32)}

    def op(state):
        state = dict(state)
        state["out"] = state["k"] + 1
        return state

    def on_batch(first, n, state):
        assert torch.equal(state["out"], torch.full_like(state["k"],
                                                         first + 1))
        seen.append((first, n, state["x"][:, 0].clone()))

    stages = split_into_stages([Operator("op", op)])
    out, _, st = StreamingScanExecutor(
        stages, prefetch_depth=depth, result_key="out").execute(
        ds, 3, extras=extras, on_batch=on_batch)
    assert out.dtype == torch.int32 and out.shape == (N,)
    np.testing.assert_array_equal(
        out.numpy(), np.arange(N) // PAGE // 3 * 3 + 1)
    # on_batch saw each batch once, in row order
    assert [(f, n) for f, n, _ in seen] == \
        [(f, min(3, ds.num_pages - f)) for f in range(0, ds.num_pages, 3)]
    np.testing.assert_array_equal(
        torch.cat([c for *_, c in seen])[:N].numpy(), x[:, 0])
    seen.clear()
    out, _, st = StreamingScanExecutor(
        stages, prefetch_depth=depth, result_key=None).execute(
        ds, 3, extras=extras, on_batch=on_batch)
    assert out is None and st.batches == len(seen) == 4
    assert st.max_in_flight <= 2 and not st.drain_async


# -- the reference's tests/test_train_streaming.py claims ---------------------


def test_training_scan_stats(tmp_path):
    store, x, y = _store("disk", tmp_path=tmp_path)
    cfg = TrainConfig(num_trees=2, max_depth=3, num_bins=16)
    res = ForestQueryEngine(store).train("d", cfg, sketch_rows=128,
                                         batch_pages=4)
    assert res.num_scans == 2 + cfg.num_trees * (cfg.max_depth + 1)
    assert len(res.scan_stats) == res.num_scans
    src_nbytes = store.get("d").nbytes
    for st in res.scan_stats:
        assert st.batches > 1 and st.max_in_flight <= 2
        assert 0 < st.bytes_streamed and \
            st.bytes_streamed / st.batches < src_nbytes
    assert res.scan_stats[0].tier == res.scan_stats[-1].tier == "disk"
    assert 0 < res.sketch_rows_used <= 128
    assert set(res.pass_s) == {"sketch", "bin_ingest", "levels"}
    assert len(res.levels) == cfg.num_trees * (cfg.max_depth + 1)
    assert [lv["level"] for lv in res.levels[:4]] == [0, 1, 2, 3]


@pytest.mark.parametrize("tier", TIERS)
def test_bins_relation_registered_in_store(tier, tmp_path):
    store, x, y = _store(tier, tmp_path=tmp_path)
    cfg = TrainConfig(num_trees=2, max_depth=2, num_bins=16)
    res = ForestQueryEngine(store).train(
        "d", cfg, edges=quantile_bin_edges(x, cfg.num_bins))
    assert res.bins_dataset == "d::bins"
    bd = store.get("d::bins")
    assert bd.dtype == torch.uint8
    assert bd.tier == tier and bd.page_rows == PAGE and bd.num_rows == N
    host = np.asarray(bd.data if tier == "disk" else bd.data.numpy())
    assert host[:N].max() <= cfg.num_bins
    assert (host[N:] == cfg.num_bins).all() and host.shape[0] > N
    assert store.catalog()["d::bins"]["bytes"] == host.shape[0] * F


@pytest.mark.parametrize("bad", ["num_bins", "labels"])
def test_refusals(bad):
    if bad == "num_bins":
        store, _, _ = _store("host")
        with pytest.raises(ValueError, match="uint8"):
            ForestQueryEngine(store).train(
                "d", TrainConfig(num_bins=256, num_trees=1))
    else:
        store = TensorBlockStore("cpu", default_page_rows=PAGE)
        store.put("u", np.zeros((8, 2), np.float32))
        with pytest.raises(ValueError, match="labels"):
            ForestQueryEngine(store).train("u", TrainConfig(num_trees=1))


def test_trained_model_lands_in_catalog_and_serves():
    from repro_torch.serve.forest import ForestServeEngine
    store, x, y = _store("host")
    eng = ForestQueryEngine(store)
    res = eng.train("d", TrainConfig(num_trees=3, max_depth=3, num_bins=16))
    assert store.get_model("d:model") is res.forest
    meta = store.model_catalog()["d:model"]
    assert meta["fingerprint"] == res.fingerprint
    assert meta["trained_on"] == "d" and meta["streamed"] is True
    assert meta["bins_dataset"] == "d::bins" and meta["num_bins"] == 16
    q = eng.infer("d", store.get_model("d:model"), plan="udf",
                  model_id=res.fingerprint)
    assert torch.isfinite(q.predictions).all()
    serve = ForestServeEngine(store, query_engine=eng)
    m = serve.register_from_catalog("d:model", warmup=False)
    out = serve.predict("d:model", x[:8])
    assert out.shape == (8,) and np.isfinite(np.asarray(out)).all()
    assert m.model_id == res.fingerprint


def test_train_metrics_and_spans():
    from test_torch_obs import _assert_cataloged
    store, x, y = _store("host")
    cfg = TrainConfig(num_trees=2, max_depth=2, num_bins=16)
    before = {k: METRICS.counter(k).value for k in
              ("train.runs", "train.trees_grown", "train.level_scans")}
    TRACER.reset()
    TRACER.enable()
    try:
        mark = TRACER.mark()
        res = ForestQueryEngine(store).train("d", cfg, sketch_rows=128)
        spans = TRACER.finished(mark)
    finally:
        TRACER.disable()
        TRACER.reset()
    names = {s.name for s in spans}
    assert {"train.forest", "train.sketch", "train.bin_ingest",
            "train.level"} <= names
    _assert_cataloged(spans)
    assert sum(s.name == "train.level" for s in spans) == \
        cfg.num_trees * (cfg.max_depth + 1)
    assert METRICS.counter("train.runs").value == before["train.runs"] + 1
    assert METRICS.counter("train.trees_grown").value == \
        before["train.trees_grown"] + cfg.num_trees
    assert METRICS.counter("train.level_scans").value == \
        before["train.level_scans"] + cfg.num_trees * (cfg.max_depth + 1)
    assert res.wall_s > 0


def test_retrain_sweeps_plans_and_decisions():
    store, x, y = _store("host")
    eng = ForestQueryEngine(store, reuse_cache=ModelReuseCache(8),
                            plan_cache=ModelReuseCache(8))
    r1 = eng.train("d", TrainConfig(num_trees=2, max_depth=2, num_bins=16,
                                    seed=1))
    fp1 = r1.fingerprint
    m1 = store.get_model("d:model")
    eng.infer("d", m1, plan="udf", model_id=fp1)
    eng.infer("d", m1, plan="auto", algorithm="predicated", model_id=fp1)
    assert any(k[1] == fp1 for k in eng.plan_cache._entries)
    assert any(k[0] == fp1 for k in store.decision_catalog())
    r2 = eng.train("d", TrainConfig(num_trees=3, max_depth=2, num_bins=16,
                                    seed=2))
    assert r2.fingerprint != fp1
    assert store.get_model("d:model") is r2.forest
    assert not any(k[1] == fp1 for k in eng.plan_cache._entries)
    assert not any(k[0] == fp1 for k in store.decision_catalog())
    q = eng.infer("d", r2.forest, plan="auto", algorithm="predicated",
                  model_id=r2.fingerprint)
    assert any(k[0] == r2.fingerprint for k in store.decision_catalog())
    assert torch.isfinite(q.predictions).all()


def test_put_model_same_forest_does_not_sweep():
    store, x, y = _store("host")
    eng = ForestQueryEngine(store)
    r = eng.train("d", TrainConfig(num_trees=2, max_depth=2, num_bins=16))
    eng.infer("d", r.forest, plan="auto", algorithm="predicated",
              model_id=r.fingerprint)
    n_before = len(store.decision_catalog())
    store.put_model("d:model", r.forest, fingerprint=r.fingerprint)
    assert len(store.decision_catalog()) == n_before


# -- the mesh half --------------------------------------------------------------


@pytest.mark.parametrize("fmt", ["dense", "csr"])
@pytest.mark.parametrize("tier", TIERS)
def test_streamed_mesh_matches_meshless(tier, fmt):
    """Every pass over a (2, 4) mesh's row shards gives the mesh-less
    forest bit for bit, and the forest lands in the catalog as one copy
    on the store's device (the rel plans place its tree shards)."""
    from repro_torch.launch.mesh import make_local_mesh
    x, y = _data(seed=7)
    cfg = TrainConfig(num_trees=4, max_depth=3, num_bins=16)
    edges = quantile_bin_edges(x, cfg.num_bins)
    flat, _, _ = _store(tier, fmt=fmt, data=(x, y))
    store = TensorBlockStore(device="cpu", default_page_rows=PAGE,
                             mesh=make_local_mesh(2, 4, devices=["cpu"] * 8),
                             **_budgets(tier))
    put = store.put_sparse if fmt == "csr" else store.put
    put("d", x, labels=y, tier="auto")
    assert store.get("d").tier == tier
    eng = ForestQueryEngine(store)
    want = ForestQueryEngine(flat).train("d", cfg, edges=edges,
                                         batch_pages=3).forest
    res = eng.train("d", cfg, edges=edges, batch_pages=3)
    assert _same(want, res.forest)
    assert all(s.batch_pages % 2 == 0 for s in res.scan_stats)
    assert store.get(res.bins_dataset).num_pages % 2 == 0
    assert store.get_model(res.model_name) is res.forest
    assert res.forest.device == store.device
    assert [lo for lo, _, _ in eng.fplan.forest_shardings(res.forest)] == \
        [0, 1, 2, 3]
    # the sketch pass on the mesh keeps the mesh-less sample
    sketched = eng.train("d", cfg, batch_pages=3)
    flat_sketch = ForestQueryEngine(flat).train("d", cfg, batch_pages=3)
    assert np.array_equal(sketched.edges, flat_sketch.edges)
    assert _same(flat_sketch.forest, sketched.forest)
