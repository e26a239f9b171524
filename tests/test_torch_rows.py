"""Port parity: ``infer_rows`` (the serving plane's entry point), the
model-partition and plan caches behind the rel plans, their sweeps, and
the rel plans' default partition count.

``infer_rows`` is held against the reference's on the same pre-padded row
batch and row mask: bit-identical on small-integer leaves of a regression
forest, NaN on masked rows.
"""

import numpy as np
import pytest
import torch

from repro.core.forest import make_forest as jmake_forest
from repro.core.reuse import ModelReuseCache as JCache
from repro.db.query import ForestQueryEngine as JEngine
from repro.db.store import TensorBlockStore as JStore
from repro_torch.core.reuse import ModelReuseCache
from repro_torch.db.query import ROW_PLAN_DATASET
from repro_torch.kernels.ops import default_tree_block

from conftest import random_forest_arrays
from test_torch_forest import port_forest
from test_torch_query import _forest, _port_engine, _rows


def _batch(B, seed=7):
    x = _rows(seed)[:B].copy()
    mask = np.ones(B, bool)
    mask[B - B // 4:] = False                       # coalescer padding rows
    x[~mask] = 0.0
    return x, mask


@pytest.mark.parametrize("plan,algorithm", [
    ("udf", "predicated_pallas_fused"), ("rel+reuse", "predicated_pallas"),
    ("udf", "hummingbird_pallas"), ("rel+reuse", "quickscorer_pallas_fused"),
    ("rel+reuse", "predicated")])
def test_infer_rows_matches_reference(plan, algorithm):
    jf = _forest(integer_leaves=True)
    x, mask = _batch(32)
    jengine = JEngine(JStore(), reuse_cache=JCache(), plan_cache=JCache())
    want = jengine.infer_rows(jf, x, row_mask=mask, algorithm=algorithm,
                              plan=plan)
    store, engine = _port_engine(_rows(7))
    tf = port_forest(jf)
    got = engine.infer_rows(tf, x, row_mask=mask, algorithm=algorithm,
                            plan=plan)
    w, g = np.asarray(want.predictions), got.predictions.numpy()
    assert np.array_equal(g[mask], w[mask])
    assert np.isnan(g[~mask]).all() and np.isnan(w[~mask]).all()
    assert got.rows_scored == want.rows_scored == int(mask.sum())
    assert got.batch_rows == want.batch_rows == 32
    assert not got.plan_reuse_hit
    again = engine.infer_rows(tf, x, row_mask=mask, algorithm=algorithm,
                              plan=plan)
    assert again.plan_reuse_hit
    assert torch.equal(again.predictions.isnan(), got.predictions.isnan())
    key = next(iter(engine.plan_cache._entries))
    assert key[0] == ("udf-row-plan" if plan == "udf" else "rel-row-plan")
    assert key[2] == ROW_PLAN_DATASET == "#rows"
    # row plans do not come from a stored dataset: a drop leaves them
    store.drop("t")
    assert len(engine.plan_cache) == 1
    assert engine.infer_rows(tf, x, row_mask=mask, algorithm=algorithm,
                             plan=plan).plan_reuse_hit


def test_infer_rows_refuses_what_serving_does_not_run():
    _, engine = _port_engine(_rows(8))
    tf = port_forest(_forest(integer_leaves=False))
    x, mask = _batch(8)
    with pytest.raises(ValueError, match="cached plans only"):
        engine.infer_rows(tf, x, plan="rel")
    with pytest.raises(ValueError, match="row_mask shape"):
        engine.infer_rows(tf, x, row_mask=mask[:4])
    with pytest.raises(ValueError, match=r"\[B, F\]"):
        engine.infer_rows(tf, x[0])
    with pytest.raises(ValueError, match="unknown algorithm"):
        engine.infer_rows(tf, x, algorithm="nope")
    res = engine.infer_rows(tf, x)                  # no mask: every row
    assert res.rows_scored == 8 and torch.isfinite(res.predictions).all()


def test_default_n_parts_follows_the_tile_of_the_kernel_launched():
    """Kernel algorithms: one partition per tree tile of the kernel they
    launch (fused or raw); the eager oracles: min(4, T); an explicit
    n_parts wins."""
    F = 60
    fe, th, dl, lv = random_forest_arrays(None, T=64, depth=6, F=F, seed=2)
    jf = jmake_forest(fe, th, lv, default_left=dl, n_features=F)
    tf = port_forest(jf)
    x = np.random.default_rng(0).normal(size=(40, F)).astype(np.float32)
    _, engine = _port_engine(x)
    fused_bt = default_tree_block(tf, fused=True)
    raw_bt = default_tree_block(tf, fused=False)
    assert (fused_bt, raw_bt) == (64, 16)
    for algorithm, want in (("predicated_pallas_fused", 64 // fused_bt),
                            ("hummingbird_pallas", 64 // raw_bt),
                            ("predicated", 4)):
        res = engine.infer("t", tf, algorithm=algorithm, plan="rel")
        assert res.n_parts == want
    assert engine.infer("t", tf, algorithm="predicated_pallas", plan="rel",
                        n_parts=5).n_parts == 5
    small = port_forest(_forest(integer_leaves=False, T=3, depth=3))
    assert engine._resolve_n_parts(small, "quickscorer", None) == 3


def test_each_n_parts_is_its_own_model_and_plan_entry():
    _, engine = _port_engine(_rows(9))
    tf = port_forest(_forest(integer_leaves=False))
    kw = dict(algorithm="predicated_pallas", plan="rel+reuse")
    a = engine.infer("t", tf, n_parts=1, **kw)
    b = engine.infer("t", tf, n_parts=3, **kw)
    assert not a.reuse_hit and not b.reuse_hit
    assert len(engine.cache) == 2 and len(engine.plan_cache) == 2
    assert engine.infer("t", tf, n_parts=1, **kw).plan_reuse_hit
    # the plan entry pins the materialization whose id() it is keyed on
    for key, entry in engine.plan_cache._entries.items():
        assert key[0] == "rel-plan" and key[-1] == id(entry.mat)
        assert any(entry.mat is m for m in engine.cache._entries.values())


def test_invalidate_sweeps_both_caches_and_drop_sweeps_rel_plans():
    store, engine = _port_engine(_rows(10))
    a = port_forest(_forest(integer_leaves=False, seed=4))
    b = port_forest(_forest(integer_leaves=False, seed=5))
    kw = dict(algorithm="quickscorer_pallas", plan="rel+reuse")
    engine.infer("t", a, model_id="a", **kw)
    engine.infer("t", b, model_id="b", **kw)
    engine.infer_rows(b, _rows(10)[:8], model_id="b", **kw)
    assert len(engine.cache) == 2 and len(engine.plan_cache) == 3
    assert engine.invalidate("a") == 2             # one model, one plan
    assert len(engine.cache) == 1 and len(engine.plan_cache) == 2
    # the dataset's rel plan goes; the model and the row plan stay
    assert store.drop("t") == 1
    assert len(engine.cache) == 1
    assert [k[0] for k in engine.plan_cache._entries] == ["rel-row-plan"]
    store.put("t", _rows(10))
    res = engine.infer("t", b, model_id="b", **kw)
    assert res.reuse_hit and not res.plan_reuse_hit and res.partition_s == 0
    assert engine.invalidate() == 3 and len(engine.cache) == 0


def test_engines_share_caches_they_are_given():
    x = _rows(11)
    tf = port_forest(_forest(integer_leaves=False))
    models, plans = ModelReuseCache(), ModelReuseCache()
    _, first = _port_engine(x, reuse_cache=models, plan_cache=plans)
    _, second = _port_engine(x, reuse_cache=models, plan_cache=plans)
    _, own = _port_engine(x)
    kw = dict(algorithm="hummingbird_pallas_fused", plan="rel+reuse")
    first.infer("t", tf, **kw)
    res = second.infer("t", tf, **kw)
    assert res.reuse_hit and second.cache is models
    assert not own.infer("t", tf, **kw).reuse_hit
    assert own.cache is not models and own.plan_cache is not plans


def test_aggregate_s_sums_the_aggregate_and_postprocess_stages():
    _, engine = _port_engine(_rows(12))
    tf = port_forest(_forest(integer_leaves=False))
    res = engine.infer("t", tf, algorithm="predicated", plan="rel")
    by_name = {r.name: r.seconds for r in res.stage_reports}
    assert res.aggregate_s == by_name["stage1:aggregate"] + \
        by_name["stage2:write"]
    assert res.aggregate_s > 0
    assert res.infer_s == by_name["stage0:cross-product:partial-agg"]
    assert res.breakdown()["aggregate"] == res.aggregate_s
    assert engine.infer("t", tf, plan="udf").aggregate_s == 0.0


def test_rel_mean_divides_by_the_true_tree_count():
    """10 trees padded to 12 for 3 partitions: a randomforest MEAN over
    the true count, against the reference."""
    fe, th, dl, lv = random_forest_arrays(None, T=10, depth=4, F=9, seed=8)
    lv = np.abs(lv) / (np.abs(lv).max() + 1.0)
    jf = jmake_forest(fe, th, lv, default_left=dl, n_features=9,
                      model_type="randomforest")
    x = _rows(13)
    jstore = JStore(default_page_rows=32)
    jstore.put("t", x)
    want = JEngine(jstore, reuse_cache=JCache(), plan_cache=JCache()).infer(
        "t", jf, algorithm="predicated_pallas", plan="rel", n_parts=3)
    _, engine = _port_engine(x)
    got = engine.infer("t", port_forest(jf), algorithm="predicated_pallas",
                       plan="rel", n_parts=3)
    np.testing.assert_allclose(got.predictions.numpy(),
                               np.asarray(want.predictions), rtol=1e-6,
                               atol=1e-6)
    partition = got.stage_reports[0]
    assert partition.name == "stageP:model-partition"
    # 12 trees of I = 15 nodes and L = 16 leaves: feature, threshold,
    # node_value (4 B), default_left, node_is_leaf (1 B), leaf_value (4 B)
    assert partition.materialized_bytes == 12 * (15 * (3 * 4 + 2) + 16 * 4)
